"""Evaluation: IoU curves (single-object), CLEAR-MOT and detection mAP.

The port's own numpy copy of `object_tracking_tpu/evaluation.py`
(framework-free, but the port imports nothing of the JAX package), on the
port's `hungarian_match`:

- `overlap_score` / `average_overlap_score`: corner-format IoU per frame
  and averaged over a sequence;
- `success_curve` / `success_auc`: the OTB success plot (fraction of
  frames with IoU > t, t ∈ [0, 1]) and its AUC;
- `evaluate_mot`: CLEAR-MOT metrics (MOTA, MOTP, FP, FN, ID switches)
  with Hungarian matching at IoU ≥ 0.5 per frame;
- `evaluate_detection`: PASCAL-VOC mAP;
- `evaluate_tracking_dataset`: both over an annotated dataset, streamed
  through a predictor's `predict_video` (the port's `JointPredictor`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from object_tracking_tpu_torch.ops.matching import hungarian_match


def _iou_corner_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized corner-format IoU of aligned box arrays (..., 4)."""
    x1 = np.maximum(a[..., 0], b[..., 0])
    y1 = np.maximum(a[..., 1], b[..., 1])
    x2 = np.minimum(a[..., 2], b[..., 2])
    y2 = np.minimum(a[..., 3], b[..., 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def overlap_score(pred_xyxy, gt_xyxy) -> float:
    """Corner-format IoU of one box pair."""
    return float(_iou_corner_np(np.asarray(pred_xyxy, np.float64),
                                np.asarray(gt_xyxy, np.float64)))


def average_overlap_score(preds, gts) -> float:
    """Mean IoU over aligned sequences."""
    preds = np.asarray(preds, np.float64)
    gts = np.asarray(gts, np.float64)
    if preds.size == 0:
        return 0.0
    return float(np.mean(_iou_corner_np(preds, gts)))


def success_curve(preds, gts, thresholds=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """OTB success plot: success rate at each IoU threshold."""
    thresholds = np.linspace(0, 1, 21) if thresholds is None \
        else np.asarray(thresholds)
    ious = _iou_corner_np(np.asarray(preds, np.float64),
                          np.asarray(gts, np.float64))
    rates = np.array([(ious > t).mean() for t in thresholds])
    return thresholds, rates


def success_auc(preds, gts) -> float:
    _, rates = success_curve(preds, gts)
    return float(rates.mean())


def _xyxy_to_cxcywh(b: np.ndarray) -> np.ndarray:
    out = np.empty_like(b, dtype=np.float32)
    out[..., 0] = 0.5 * (b[..., 0] + b[..., 2])
    out[..., 1] = 0.5 * (b[..., 1] + b[..., 3])
    out[..., 2] = b[..., 2] - b[..., 0]
    out[..., 3] = b[..., 3] - b[..., 1]
    return out


def evaluate_mot(gt_frames: Sequence[Dict[int, np.ndarray]],
                 pred_frames: Sequence[Dict[int, np.ndarray]],
                 iou_threshold: float = 0.5) -> Dict[str, float]:
    """CLEAR-MOT over a sequence.

    Args:
      gt_frames / pred_frames: per frame, {track_id: box_xyxy}.

    Returns:
      dict with mota, motp, fp, fn, id_switches, num_gt, matches.
    """
    fp = fn = idsw = matches = 0
    iou_sum = 0.0
    num_gt = 0
    last_match: Dict[int, int] = {}       # gt id → pred id

    for gt, pred in zip(gt_frames, pred_frames):
        gt_ids = list(gt.keys())
        pr_ids = list(pred.keys())
        num_gt += len(gt_ids)
        if gt_ids and pr_ids:
            gt_boxes = _xyxy_to_cxcywh(
                np.stack([np.asarray(gt[i], np.float32)
                          for i in gt_ids]))
            pr_boxes = _xyxy_to_cxcywh(
                np.stack([np.asarray(pred[i], np.float32)
                          for i in pr_ids]))
            pairs = hungarian_match(gt_boxes, pr_boxes, iou_threshold)
        else:
            pairs = []
        matched_gt = set()
        matched_pr = set()
        for gi, pi in pairs:
            g_id, p_id = gt_ids[gi], pr_ids[pi]
            matched_gt.add(g_id)
            matched_pr.add(p_id)
            if g_id in last_match and last_match[g_id] != p_id:
                idsw += 1
            last_match[g_id] = p_id
            iou_sum += overlap_score(gt[g_id], pred[p_id])
            matches += 1
        fn += len(gt_ids) - len(matched_gt)
        fp += len(pr_ids) - len(matched_pr)

    mota = 1.0 - (fn + fp + idsw) / max(num_gt, 1)
    motp = iou_sum / max(matches, 1)
    return {'mota': mota, 'motp': motp, 'fp': fp, 'fn': fn,
            'id_switches': idsw, 'num_gt': num_gt, 'matches': matches}


def _pairwise_iou_corner(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) corner-format IoU matrix."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    return _iou_corner_np(a[:, None, :].astype(np.float64),
                          b[None, :, :].astype(np.float64))


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """Area under the monotone precision envelope (VOC2010+ AP)."""
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    # Monotone non-increasing envelope, right to left.
    p = np.maximum.accumulate(p[::-1])[::-1]
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def evaluate_detection(gt_frames: Sequence[Dict[str, np.ndarray]],
                       pred_frames: Sequence[Dict[str, np.ndarray]],
                       iou_threshold: float = 0.5
                       ) -> Dict[str, object]:
    """PASCAL-VOC detection mAP over a dataset.

    Args:
      gt_frames: per image {'boxes': (M, 4) xyxy, 'labels': (M,) int}.
      pred_frames: per image {'boxes': (N, 4) xyxy, 'scores': (N,),
        'labels': (N,) int}.
      iou_threshold: match threshold (VOC uses 0.5).

    Returns:
      {'map': float, 'ap_per_class': {class_id: ap},
       'num_gt_per_class': {class_id: count}}.
    """
    classes = sorted({int(l) for f in gt_frames
                      for l in np.asarray(f['labels']).reshape(-1)} |
                     {int(l) for f in pred_frames
                      for l in np.asarray(f['labels']).reshape(-1)})
    # label -1 marks "not in the evaluated label set" (unknown classes);
    # it is excluded — it would otherwise form a phantom class.
    classes = [c for c in classes if c >= 0]
    ap_per_class: Dict[int, float] = {}
    ngt_per_class: Dict[int, int] = {}
    pred_only: Dict[int, float] = {}
    for c in classes:
        # (score, image_idx, box) for every class-c detection.
        dets = []
        for i, f in enumerate(pred_frames):
            labels = np.asarray(f['labels']).reshape(-1)
            for j in np.where(labels == c)[0]:
                dets.append((float(np.asarray(f['scores'])[j]), i,
                             np.asarray(f['boxes'])[j]))
        dets.sort(key=lambda d: -d[0])
        gt_boxes = [np.asarray(f['boxes']).reshape(-1, 4)[
            np.asarray(f['labels']).reshape(-1) == c]
            for f in gt_frames]
        ngt = int(sum(len(g) for g in gt_boxes))
        ngt_per_class[c] = ngt
        if ngt == 0:
            # VOC convention: classes absent from GT don't enter the mean
            # (their recall is undefined). Detections of such classes are
            # reported separately instead of forcing AP=0 into the mAP.
            if dets:
                pred_only[c] = 0.0
            continue
        used = [np.zeros(len(g), bool) for g in gt_boxes]
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for k, (_, i, box) in enumerate(dets):
            iou = _pairwise_iou_corner(box[None], gt_boxes[i])[0]
            best = int(np.argmax(iou)) if iou.size else -1
            if best >= 0 and iou[best] >= iou_threshold \
                    and not used[i][best]:
                used[i][best] = True
                tp[k] = 1
            else:
                fp[k] = 1
        cum_tp, cum_fp = np.cumsum(tp), np.cumsum(fp)
        recall = cum_tp / ngt
        precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
        ap_per_class[c] = average_precision(recall, precision)
    m = float(np.mean(list(ap_per_class.values()))) \
        if ap_per_class else 0.0
    return {'map': m, 'ap_per_class': ap_per_class,
            'num_gt_per_class': ngt_per_class,
            'pred_only_classes': pred_only}


def evaluate_tracking_dataset(predictor, annotations,
                              window: int = 4,
                              iou_threshold: float = 0.5
                              ) -> Dict[str, Dict[str, float]]:
    """End-to-end CLEAR-MOT over an annotated dataset.

    Groups `annotations` (each with `folder`, `filename`, `width`,
    `height` and `objects`, each object with `label`, `box_xyxy` and
    `trackid`, as VOC annotations parse) by video (`folder`), streams
    each video through `predictor.predict_video`, converts predictions to
    pixel xyxy, and aggregates per-video CLEAR-MOT into an 'overall'
    entry, with the detection mAP of the same predictions.
    """
    videos: Dict[str, list] = {}
    for ann in annotations:
        videos.setdefault(ann.folder, []).append(ann)

    label_to_id = {name: i for i, name in
                   enumerate(getattr(predictor, 'labels', ()))}
    det_gt_frames: List[Dict[str, np.ndarray]] = []
    det_pred_frames: List[Dict[str, np.ndarray]] = []

    results: Dict[str, Dict[str, float]] = {}
    totals = {'fp': 0, 'fn': 0, 'id_switches': 0, 'num_gt': 0,
              'matches': 0}
    iou_weighted = 0.0
    for name, anns in sorted(videos.items()):
        anns = sorted(anns, key=lambda a: a.filename)
        # predict_video pads its final partial window internally, so every
        # frame of every video is evaluated — no tail truncation.
        preds = predictor.predict_video([a.filename for a in anns],
                                        window=window)
        gt_frames, pred_frames = [], []
        for ann, dets in zip(anns, preds):
            # Objects without a trackid key into the negative range so
            # they can never collide with a real trackid in the frame.
            gt_frames.append({
                obj.trackid if obj.trackid >= 0 else -(i + 1):
                    np.asarray(obj.box_xyxy, np.float32)
                for i, obj in enumerate(ann.objects)})
            det_gt_frames.append({
                'boxes': np.asarray(
                    [obj.box_xyxy for obj in ann.objects],
                    np.float32).reshape(-1, 4),
                'labels': np.asarray(
                    [label_to_id.get(obj.label, -1)
                     for obj in ann.objects], np.int32)})
            frame = {}
            boxes_px, scores, labels_ids = [], [], []
            for d in dets:
                cx, cy, w, h = d['box']
                xyxy = np.asarray(
                    [(cx - w / 2) * ann.width, (cy - h / 2) * ann.height,
                     (cx + w / 2) * ann.width, (cy + h / 2) * ann.height],
                    np.float32)
                frame[d['track_id']] = xyxy
                boxes_px.append(xyxy)
                scores.append(d['score'])
                labels_ids.append(label_to_id.get(d['label'], -1))
            pred_frames.append(frame)
            det_pred_frames.append({
                'boxes': np.asarray(boxes_px, np.float32).reshape(-1, 4),
                'scores': np.asarray(scores, np.float32),
                'labels': np.asarray(labels_ids, np.int32)})
        m = evaluate_mot(gt_frames, pred_frames, iou_threshold)
        results[name] = m
        for k in totals:
            totals[k] += m[k]
        iou_weighted += m['motp'] * m['matches']

    overall = dict(totals)
    overall['mota'] = 1.0 - (
        (totals['fn'] + totals['fp'] + totals['id_switches'])
        / max(totals['num_gt'], 1))
    overall['motp'] = iou_weighted / max(totals['matches'], 1)
    det = evaluate_detection(det_gt_frames, det_pred_frames,
                             iou_threshold)
    overall['map'] = det['map']
    results['detection'] = {f'ap_{c}': v
                            for c, v in det['ap_per_class'].items()}
    results['detection']['map'] = det['map']
    results['overall'] = overall
    return results
