"""The port's dataset converters against the JAX package's.

Mirrors the converter cases of tests/test_data.py (MOT17 and VisualTB
→ VOC XML, the train/val split, VisualTB's delimiter sniffing, irregular
start frames, ground-truth frame ranges and multi-file track ids, and the
`convert` command with a legacy class map). Each case runs the port's
converter and JAX's on the same input tree into two output trees, which
must hold the same files, byte for byte, and the same count.
"""

import json
import os
from pathlib import Path

import numpy as np

from object_tracking_tpu.data.converters import mot_to_voc as jmot
from object_tracking_tpu.data.converters import visualtb_to_voc as jtb
from object_tracking_tpu_torch import trainer
from object_tracking_tpu_torch.data import parse_annotation_dir
from object_tracking_tpu_torch.data.converters import (mot_to_voc,
                                                       visualtb_to_voc)


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def _mot(root: Path, name='SEQ-01', rows=None, split='train') -> Path:
    seq = root / 'mot' / split / name
    (seq / 'gt').mkdir(parents=True)
    (seq / 'seqinfo.ini').write_text(
        f'[Sequence]\nname={name}\nimDir=img1\nframeRate=30\n'
        'seqLength=4\nimWidth=640\nimHeight=480\nimExt=.jpg\n')
    rows = rows or [
        '1,1,10,20,30,40,1,1,1.0', '1,2,50,60,20,20,1,3,1.0',
        '2,1,12,22,30,40,1,1,1.0', '3,1,14,24,30,40,0,1,1.0',
        '4,1,16,26,30,40,1,1,1.0']
    (seq / 'gt' / 'gt.txt').write_text('\n'.join(rows) + '\n')
    return root / 'mot'


def test_mot_to_voc_matches_jax(tmp_path):
    mot = _mot(tmp_path)
    _mot(tmp_path, name='SEQ-09', split='test')
    dirs = [str(mot / 'train'), str(mot / 'test')]
    n = mot_to_voc(dirs, str(tmp_path / 'port'), validation_split=0.25)
    assert n == jmot(dirs, str(tmp_path / 'jax'), validation_split=0.25) == 8
    port = _tree(tmp_path / 'port')
    assert port == _tree(tmp_path / 'jax')
    assert len([k for k in port if k.startswith('train/SEQ-01')]) == 3
    assert len([k for k in port if k.startswith('test/SEQ-09')]) == 4
    anns, _ = parse_annotation_dir(str(tmp_path / 'port' / 'train'), '/imgs')
    first = [a for a in anns if a.filename.endswith('000001.jpg')][0]
    assert first.width == 640 and first.height == 480
    assert {o.label for o in first.objects} == {'1', '3'}
    car = [o for o in first.objects if o.label == '1'][0]
    assert (car.xmin, car.ymin, car.xmax, car.ymax) == (10, 20, 40, 60)
    assert car.trackid == 1 and first.folder == 'SEQ-01/img1'


def test_mot_to_voc_drops_ignored_rows_like_jax(tmp_path):
    mot = _mot(tmp_path)
    kw = dict(validation_split=0.0, keep_ignored=False)
    n = mot_to_voc([str(mot / 'train')], str(tmp_path / 'port'), **kw)
    assert n == jmot([str(mot / 'train')], str(tmp_path / 'jax'), **kw) == 3
    assert _tree(tmp_path / 'port') == _tree(tmp_path / 'jax')


def _tb(root: Path) -> Path:
    tb = root / 'tb'
    (tb / 'Walking').mkdir(parents=True)
    # whitespace- and comma-delimited rows, sniffed per line
    (tb / 'Walking' / 'groundtruth_rect.txt').write_text(
        '10 20 30 40\n12,22,30,40\n\n14 24 30 40\n16 26 30 40\n')
    (tb / 'Jogging').mkdir()
    (tb / 'Jogging' / 'groundtruth_rect.1.txt').write_text(
        '1,1,5,5\n2,2,5,5\n')
    (tb / 'Jogging' / 'groundtruth_rect.2.txt').write_text(
        '8,8,5,5\n9,9,5,5\n')
    # an irregular start frame
    (tb / 'BlurCar3').mkdir()
    (tb / 'BlurCar3' / 'groundtruth_rect.txt').write_text(
        '1,2,3,4\n5,6,7,8\n9,10,11,12\n')
    # ground truth over a frame range only
    (tb / 'Freeman4').mkdir()
    (tb / 'Freeman4' / 'groundtruth_rect.txt').write_text(
        ''.join(f'{i},{i},4,4\n' for i in range(285)))
    (tb / 'Unmapped').mkdir()
    (tb / 'Unmapped' / 'groundtruth_rect.txt').write_text('1,1,1,1\n')
    return tb


def test_visualtb_to_voc_matches_jax(tmp_path):
    tb = _tb(tmp_path)
    cmap = {'Walking': 'Person', 'Jogging': 'Person', 'BlurCar3': 'Car',
            'Freeman4': 'Person'}
    outs = {}
    for name, fn in (('port', visualtb_to_voc), ('jax', jtb)):
        outs[name] = fn(str(tb), str(tmp_path / name / 't'),
                        str(tmp_path / name / 'v'), class_map=cmap,
                        image_size=(640, 360))
    assert outs['port'] == outs['jax'] == 4 + 2 + 3 + 283
    port = _tree(tmp_path / 'port')
    assert port == _tree(tmp_path / 'jax')
    assert 't/BlurCar3/0003.xml' in port and not any('Unmapped' in k
                                                     for k in port)
    anns, _ = parse_annotation_dir(str(tmp_path / 'port' / 't'), '/imgs')
    jog = {os.path.basename(a.filename): a for a in anns
           if a.folder == 'Jogging/img'}
    assert {o.trackid for o in jog['0001.jpg'].objects} == {0, 1}


def test_visualtb_image_size_probe_like_jax(tmp_path):
    """Without image_size the first frame is probed with cv2."""
    import cv2
    tb = _tb(tmp_path)
    (tb / 'Walking' / 'img').mkdir()
    cv2.imwrite(str(tb / 'Walking' / 'img' / '0001.jpg'),
                np.zeros((60, 80, 3), np.uint8))
    cmap = {'Walking': 'Person', 'Jogging': 'Person'}
    n = visualtb_to_voc(str(tb), str(tmp_path / 'port' / 't'),
                        str(tmp_path / 'port' / 'v'), class_map=cmap)
    assert n == jtb(str(tb), str(tmp_path / 'jax' / 't'),
                    str(tmp_path / 'jax' / 'v'), class_map=cmap) == 4
    port = _tree(tmp_path / 'port')
    assert port == _tree(tmp_path / 'jax')
    assert b'<width>80</width>' in port['t/Walking/0001.xml']


def test_convert_command_matches_jax(tmp_path):
    """`convert mot` and `convert visualtb` (with a legacy config.json
    class map) through both packages' command lines."""
    import cv2

    from object_tracking_tpu.trainer import main as jmain
    mot = _mot(tmp_path)
    tb = _tb(tmp_path)
    (tb / 'Walking' / 'img').mkdir()      # the image-size probe's frame
    cv2.imwrite(str(tb / 'Walking' / 'img' / '0001.jpg'),
                np.zeros((60, 80, 3), np.uint8))
    cmap = tmp_path / 'config.json'
    cmap.write_text(json.dumps({'classes_map': {'Walking': 'Person'}}))
    for name, main in (('port', trainer.main), ('jax', jmain)):
        out = tmp_path / name
        assert main(['convert', 'mot', '--src', str(mot), '--out',
                     str(out / 'mot')]) == 0
        assert main(['convert', 'visualtb', '--src', str(tb), '--out',
                     str(out / 'tb'), '--class-map', str(cmap),
                     '--val-split', '0.5']) == 0
    port = _tree(tmp_path / 'port')
    assert port == _tree(tmp_path / 'jax')
    assert len([k for k in port if k.startswith('mot/train/')]) == 3
    assert len([k for k in port if k.startswith('tb/')]) == 4
    assert trainer.convert_dataset('mot', str(mot), str(tmp_path / 'x')) == 4
