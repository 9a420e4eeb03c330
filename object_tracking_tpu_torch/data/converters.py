"""Offline dataset converters → PASCAL-VOC XML trees.

The port's own copy of `object_tracking_tpu/data/converters.py` (plain
Python, no tensors), so that the port imports nothing of the JAX package:

- MOT17: per-sequence `seqinfo.ini` (name, imDir, seqLength, imWidth,
  imHeight, imExt) and `gt/gt.txt` rows of 9 fields (frame, trackid, box
  left/top/width/height, conf flag, class id, visibility). Class id
  strings become the label names; rows with conf flag 0 (MOT's "ignore"
  entries) are kept unless `keep_ignored=False`.
- VisualTB: per-sequence `groundtruth_rect*.txt` of x,y,w,h rows, with
  the irregular start frames and ground-truth frame ranges of a few
  sequences, one trackid per ground-truth file, and comma or whitespace
  delimiters sniffed per line.

Both write `<object><name/><trackid/><bndbox/></object>` per instance and
split train/val 75/25 by frame position within each sequence.
"""

from __future__ import annotations

import configparser
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

# Sequences whose images don't start at 0001.jpg
VISUALTB_START_FRAME: Dict[str, int] = {
    'BlurCar1': 247, 'BlurCar3': 3, 'BlurCar4': 18,
}
# GT covers only these frame ranges
VISUALTB_SKIP_MAP: Dict[str, Tuple[int, int]] = {
    'David': (300, 770), 'Freeman4': (1, 283),
}


def _write_voc_xml(path: str, folder: str, filename: str, width, height,
                   objects: List[dict], database: str) -> None:
    ann = ET.Element('annotation')
    ET.SubElement(ann, 'folder').text = folder
    ET.SubElement(ann, 'filename').text = filename
    src = ET.SubElement(ann, 'source')
    ET.SubElement(src, 'database').text = database
    size = ET.SubElement(ann, 'size')
    ET.SubElement(size, 'width').text = str(width)
    ET.SubElement(size, 'height').text = str(height)
    ET.SubElement(size, 'depth').text = '3'
    for obj in objects:
        o = ET.SubElement(ann, 'object')
        ET.SubElement(o, 'name').text = str(obj['name'])
        ET.SubElement(o, 'trackid').text = str(obj['trackid'])
        bb = ET.SubElement(o, 'bndbox')
        for k in ('xmin', 'ymin', 'xmax', 'ymax'):
            ET.SubElement(bb, k).text = str(obj[k])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ET.ElementTree(ann).write(path)


def _split_dir(base: str, is_train_dir: bool, index: int, total: int,
               validation_split: float) -> str:
    if not is_train_dir:
        return os.path.join(base, 'test')
    if index <= (1.0 - validation_split) * total:
        return os.path.join(base, 'train')
    return os.path.join(base, 'val')


def mot_to_voc(mot_label_dirs: Sequence[str], out_dir: str,
               validation_split: float = 0.25,
               keep_ignored: bool = True) -> int:
    """Convert MOT17-style label dirs to per-frame VOC XML.

    Args:
      mot_label_dirs: e.g. [.../train/, .../test/] — each containing
        sequence dirs with seqinfo.ini and gt/gt.txt.
      out_dir: root for train/ val/ test/ trees.
      keep_ignored: keep rows with conf flag 0 (as the reference does).

    Returns number of XML files written.
    """
    written = 0
    for label_dir in mot_label_dirs:
        is_train = os.path.basename(os.path.normpath(label_dir)) == 'train'
        if not os.path.isdir(label_dir):
            continue
        for seq in sorted(os.listdir(label_dir)):
            seq_dir = os.path.join(label_dir, seq)
            ini = os.path.join(seq_dir, 'seqinfo.ini')
            gt = os.path.join(seq_dir, 'gt', 'gt.txt')
            if not (os.path.isfile(ini) and os.path.isfile(gt)):
                continue
            cp = configparser.ConfigParser()
            cp.read(ini)
            sec = cp['Sequence']
            name = sec.get('name', seq)
            imdir = sec.get('imDir', 'img1')
            width = sec.get('imWidth', '0')
            height = sec.get('imHeight', '0')
            imext = sec.get('imExt', '.jpg')

            frames: Dict[int, List[dict]] = {}
            with open(gt) as f:
                for line in f:
                    parts = line.strip().split(',')
                    if len(parts) < 9:
                        continue
                    frame, tid = int(parts[0]), parts[1]
                    x, y = float(parts[2]), float(parts[3])
                    w, h = float(parts[4]), float(parts[5])
                    conf, class_id = parts[6], parts[7]
                    if not keep_ignored and conf == '0':
                        continue
                    frames.setdefault(frame, []).append({
                        'trackid': tid, 'name': class_id,
                        'xmin': int(x), 'ymin': int(y),
                        'xmax': int(x + w), 'ymax': int(y + h)})

            total = len(frames)
            for count, frame in enumerate(sorted(frames), start=1):
                dest = _split_dir(out_dir, is_train, count, total,
                                  validation_split)
                fname = f'{frame:06d}'
                _write_voc_xml(
                    os.path.join(dest, name, fname + '.xml'),
                    folder=f'{name}/{imdir}', filename=fname + imext,
                    width=width, height=height, objects=frames[frame],
                    database='MOT17')
                written += 1
    return written


def _parse_rect_line(line: str) -> Optional[Tuple[float, ...]]:
    line = line.strip()
    if not line:
        return None
    parts = line.split(',') if ',' in line else line.split()
    try:
        vals = tuple(float(p) for p in parts)
    except ValueError:
        return None
    return vals if len(vals) == 4 else None


def visualtb_to_voc(tb_dir: str, out_train: str, out_val: str,
                    class_map: Dict[str, str],
                    validation_split: float = 0.25,
                    image_size: Optional[Tuple[int, int]] = None) -> int:
    """Convert VisualTB sequences to per-frame VOC XML.

    Args:
      tb_dir: root containing <Seq>/groundtruth_rect*.txt + <Seq>/img/.
      class_map: sequence-dir → class-name map (the reference's
        config.json 'classes_map' block).
      image_size: (width, height) override; if None, probed from the
        first frame with cv2.

    Returns number of XML files written.
    """
    written = 0
    for seq in sorted(os.listdir(tb_dir)):
        seq_dir = os.path.join(tb_dir, seq)
        if not os.path.isdir(seq_dir) or seq not in class_map:
            continue
        gt_files = sorted(
            f for f in os.listdir(seq_dir)
            if f.startswith('groundtruth_rect') and f.endswith('.txt')
            and not f.startswith('._'))
        if not gt_files:
            continue
        start = VISUALTB_START_FRAME.get(seq, 1)
        if image_size is not None:
            width, height = image_size
        else:
            import cv2
            probe = os.path.join(seq_dir, 'img', f'{start:04d}.jpg')
            img = cv2.imread(probe)
            if img is None:
                continue
            height, width = img.shape[:2]

        frames: Dict[int, List[dict]] = {}
        for trackid, gt_file in enumerate(gt_files):
            frame = start
            with open(os.path.join(seq_dir, gt_file)) as f:
                for line in f:
                    rect = _parse_rect_line(line)
                    if rect is None:
                        continue
                    lo_hi = VISUALTB_SKIP_MAP.get(seq)
                    if lo_hi and not (lo_hi[0] <= frame <= lo_hi[1]):
                        frame += 1
                        continue
                    x, y, w, h = rect
                    frames.setdefault(frame, []).append({
                        'trackid': trackid, 'name': class_map[seq],
                        'xmin': int(x), 'ymin': int(y),
                        'xmax': int(x + w), 'ymax': int(y + h)})
                    frame += 1

        total = len(frames)
        for count, frame in enumerate(sorted(frames), start=1):
            dest = out_train if count <= (1 - validation_split) * total \
                else out_val
            fname = f'{frame:04d}'
            _write_voc_xml(
                os.path.join(dest, seq, fname + '.xml'),
                folder=f'{seq}/img', filename=fname + '.jpg',
                width=width, height=height, objects=frames[frame],
                database='VisualTB')
            written += 1
    return written
