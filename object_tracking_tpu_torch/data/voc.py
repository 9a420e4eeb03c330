"""PASCAL-VOC-style annotation parsing.

A copy of `object_tracking_tpu/data/voc.py` (numpy/xml only; the port
imports nothing of the JAX package): a recursive walk of an annotation
directory, folder/filename/size/object/bndbox extraction including objects
nested under `part`, the `.JPEG` fallback of ImageNet-VID, label filtering
with a census of every label seen, images without a kept object dropped,
`trackid` kept, and an optional pickle cache keyed by the XML set, its
newest mtime and the labels.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class ObjectAnnotation:
    label: str
    xmin: float
    ymin: float
    xmax: float
    ymax: float
    trackid: int = -1

    @property
    def box_xyxy(self) -> Tuple[float, float, float, float]:
        return (self.xmin, self.ymin, self.xmax, self.ymax)


@dataclass
class Annotation:
    filename: str          # absolute image path
    folder: str            # video/sequence id (VOC <folder>)
    width: int
    height: int
    objects: List[ObjectAnnotation] = field(default_factory=list)


def _parse_object(elem, obj_out: List[ObjectAnnotation],
                  seen: Dict[str, int],
                  labels: Optional[Sequence[str]]) -> None:
    name, trackid, box = None, -1, None
    for attr in elem:
        tag = attr.tag.lower()
        if tag == 'name':
            name = (attr.text or '').strip()
        elif tag == 'trackid':
            try:
                trackid = int(attr.text)
            except (TypeError, ValueError):
                trackid = -1
        elif tag == 'bndbox':
            vals = {}
            for d in attr:
                try:
                    vals[d.tag.lower()] = float(d.text)
                except (TypeError, ValueError):
                    pass
            if all(k in vals for k in ('xmin', 'ymin', 'xmax', 'ymax')):
                box = (vals['xmin'], vals['ymin'],
                       vals['xmax'], vals['ymax'])
        elif tag == 'part':
            # parts are parsed like objects (preprocessing.py:46)
            _parse_object(attr, obj_out, seen, labels)
    if name is None or box is None:
        return
    seen[name] = seen.get(name, 0) + 1
    if labels is not None and name not in labels:
        return
    obj_out.append(ObjectAnnotation(name, *box, trackid=trackid))


def parse_annotation(xml_path: str, image_dir: str,
                     labels: Optional[Sequence[str]] = None,
                     seen: Optional[Dict[str, int]] = None
                     ) -> Optional[Annotation]:
    """Parse one VOC XML file; returns None if no kept objects."""
    seen = {} if seen is None else seen
    try:
        root = ET.parse(xml_path).getroot()
    except ET.ParseError:
        return None
    folder, filename, width, height = '', '', 0, 0
    objects: List[ObjectAnnotation] = []
    for elem in root:
        tag = elem.tag.lower()
        if tag == 'folder':
            folder = (elem.text or '').strip()
        elif tag == 'filename':
            filename = (elem.text or '').strip()
            if '.' not in os.path.basename(filename):
                filename += '.JPEG'   # ImageNet-VID (:40-41)
        elif tag == 'size':
            for d in elem:
                if d.tag.lower() == 'width':
                    width = int(float(d.text))
                elif d.tag.lower() == 'height':
                    height = int(float(d.text))
        elif tag == 'object':
            _parse_object(elem, objects, seen, labels)
    if not objects:
        return None                    # (:74-75)
    path = os.path.join(image_dir, folder, filename) if folder else \
        os.path.join(image_dir, filename)
    return Annotation(filename=path, folder=folder, width=width,
                      height=height, objects=objects)


def _xml_walk(annot_dir: str) -> List[str]:
    paths = []
    for root, _, files in sorted(os.walk(annot_dir)):
        paths.extend(os.path.join(root, f) for f in sorted(files)
                     if f.endswith('.xml'))
    return paths


def _cache_key(xml_paths: Sequence[str], image_dir: str,
               labels: Optional[Sequence[str]]) -> str:
    """Fingerprint of the annotation tree: file set + newest mtime +
    target labels. Walking mtimes is cheap next to parsing the XML."""
    import hashlib
    h = hashlib.sha1()
    h.update(os.path.abspath(image_dir).encode())
    h.update(repr(tuple(labels) if labels else None).encode())
    newest = 0.0
    for p in xml_paths:
        h.update(p.encode())
        try:
            newest = max(newest, os.path.getmtime(p))
        except OSError:
            pass
    h.update(f'{len(xml_paths)}:{newest}'.encode())
    return h.hexdigest()


def parse_annotation_dir(annot_dir: str, image_dir: str,
                         labels: Optional[Sequence[str]] = None,
                         cache_dir: Optional[str] = None
                         ) -> Tuple[List[Annotation], Dict[str, int]]:
    """Recursive walk (preprocessing.py:18-25); returns (annotations,
    label census). Sorted by path for deterministic windowing.

    `cache_dir` enables a parsed-annotation pickle cache (the
    reference's `load_data_generators` pickle, KerasYOLO.py:421-439),
    keyed by the XML file set + newest mtime + label list, so a changed
    tree re-parses automatically instead of serving stale entries.
    """
    xml_paths = _xml_walk(annot_dir)
    cache_file = None
    if cache_dir:
        import pickle
        key = _cache_key(xml_paths, image_dir, labels)
        cache_file = os.path.join(cache_dir, f'annotations_{key}.pkl')
        if os.path.isfile(cache_file):
            try:
                with open(cache_file, 'rb') as f:
                    return pickle.load(f)
            except Exception:
                pass                       # corrupt cache → re-parse

    anns: List[Annotation] = []
    seen: Dict[str, int] = {}
    for p in xml_paths:
        ann = parse_annotation(p, image_dir, labels, seen)
        if ann is not None:
            anns.append(ann)
    anns.sort(key=lambda a: a.filename)

    if cache_file:
        import pickle
        os.makedirs(cache_dir, exist_ok=True)
        tmp = cache_file + '.tmp'
        with open(tmp, 'wb') as f:
            pickle.dump((anns, seen), f)
        os.replace(tmp, cache_file)        # atomic publish
    return anns, seen
