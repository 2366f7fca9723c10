"""Devkit-faithful KITTI AP evaluation on the host (numpy), a copy of
`dcf.eval.kitti_eval`.

A dependency-free numpy reimplementation of the official KITTI devkit
protocol (`evaluate_object_3d_offline.cpp`, as the numba
`kitti-object-eval-python` port runs it). Rotated BEV / 3D IoU and the
matching stay on the host in float64, as in the reference: an IoU near
the 0.7 Car threshold is decided as the reference decides it, which a
float32 device IoU would not guarantee.

Devkit semantics:

  - clean_data: per class x difficulty, gts are valid (counted), ignored
    (matching costs nothing: similar class Van~Car / Person_sitting~
    Pedestrian, or truncation/occlusion/2D-box-height beyond the
    difficulty cap), or irrelevant (other classes). Detections whose 2D
    box height is below the difficulty's min height are ignored.
  - DontCare regions: unmatched detections overlapping a DontCare 2D box
    (intersection / det area > threshold) are not false positives. As in
    the devkit this applies to the 2D-bbox metric only (DontCare labels
    carry no 3D box).
  - matching: per ground truth, the highest-overlap valid detection above
    the class min-overlap (score-descending for threshold collection),
    greedy in gt order, each detection assigned at most once.
  - AP: tp-score thresholds sampled at 1/(N-1) recall steps
    (`get_thresholds`), precision made monotone from the right, then
    R40 = mean of samples 1..40 (post-2019 standard), R11 = mean of
    samples 0,4,...,40 (pre-2019). `num_points=0` gives the exact
    area-under-PR AP over every achieved recall (useful for small
    synthetic fixtures, where the 41-sample grid quantizes to ~k/41).
  - AOS (orientation similarity) for the bbox metric when alphas are
    present.

The rotated IoUs and the matching at every score threshold of a frame
run in the compiled host core (`dcf_torch.native`: `rotated_iou_bev`,
`iou_3d`, one `eval_statistics` call per frame and cell), as they run in
the reference's C++. Their plain versions stay in numpy and Python:
`geometry.np_boxes`'s IoUs and `_frame_statistics` here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from dcf_torch import native
from dcf_torch.data.kitti import box7_to_camera_label
from dcf_torch.geometry.np_boxes import boxes3d_corners

CLASS_NAMES = ("Car", "Pedestrian", "Cyclist")
DIFFICULTIES = ("easy", "moderate", "hard")
CLASS_IOU_THRESHOLDS = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
# 2D-bbox metric uses its own min overlaps (same values at the "hard"
# setting of the official devkit).
CLASS_IOU_THRESHOLDS_BBOX = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}

# Official difficulty caps (devkit evaluate_object.cpp).
MIN_HEIGHT = (40.0, 25.0, 25.0)          # px, 2D box height
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.30, 0.50)
# Classes whose gts are ignored (not fp if matched) for a target class.
SIMILAR_CLASSES = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}
N_SAMPLE_PTS = 41


# --------------------------------------------------------------------------
# Annotations
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Annotation:
    """Per-frame labels or detections in devkit-complete form.

    DontCare / Van / etc. rows are kept (names is the raw class string);
    their boxes7 rows may be zeros (DontCare has no 3D box).
    """

    names: List[str]
    boxes7: np.ndarray               # [N, 7] lidar-frame box7
    bbox2d: np.ndarray               # [N, 4] image-plane (x1, y1, x2, y2)
    truncated: np.ndarray            # [N] float
    occluded: np.ndarray             # [N] float/int
    alpha: Optional[np.ndarray] = None    # [N] observation angle
    scores: Optional[np.ndarray] = None   # [N] detections only

    def __len__(self) -> int:
        return len(self.names)


def annotation_from_frame(frame) -> Annotation:
    """Build a gt Annotation from a `Frame` (`dcf_torch.data.kitti`).

    Uses `frame.raw_labels` (the unfiltered label-file parse, including
    DontCare and similar classes) when the dataset provides it; otherwise
    falls back to the filtered per-class fields.
    """
    raw = getattr(frame, "raw_labels", None)
    if raw is not None:
        return Annotation(
            names=list(raw["names"]),
            boxes7=np.asarray(raw["boxes7"], np.float64).reshape(-1, 7),
            bbox2d=np.asarray(raw["bbox2d"], np.float64).reshape(-1, 4),
            truncated=np.asarray(raw["truncated"], np.float64).reshape(-1),
            occluded=np.asarray(raw["occluded"], np.float64).reshape(-1),
            alpha=np.asarray(raw["alpha"], np.float64).reshape(-1))
    n = len(frame.boxes)
    bbox2d = (np.asarray(frame.bbox2d, np.float64).reshape(-1, 4)
              if frame.bbox2d is not None else
              np.tile([0.0, 0.0, 50.0, 50.0], (n, 1)))
    return Annotation(
        names=[CLASS_NAMES[c] for c in frame.labels],
        boxes7=np.asarray(frame.boxes, np.float64).reshape(-1, 7),
        bbox2d=bbox2d,
        truncated=(np.asarray(frame.truncated, np.float64).reshape(-1)
                   if frame.truncated is not None else np.zeros(n)),
        occluded=(np.asarray(frame.occluded, np.float64).reshape(-1)
                  if frame.occluded is not None else np.zeros(n)),
        alpha=(np.asarray(frame.alpha, np.float64).reshape(-1)
               if frame.alpha is not None else None))


def detection_annotation(boxes7, scores, class_ids, calib=None,
                         image_shape=None) -> Annotation:
    """Build a det Annotation from inference outputs.

    When `calib` is given, 2D boxes are the image-plane projection of the
    3D box corners (the devkit filters detections by 2D box height);
    otherwise tall placeholder boxes are used so no detection is
    height-filtered.
    """
    boxes7 = np.asarray(boxes7, np.float64).reshape(-1, 7)
    scores = np.asarray(scores, np.float64).reshape(-1)
    class_ids = np.asarray(class_ids, np.int32).reshape(-1)
    n = len(boxes7)
    alpha = None
    if calib is not None and n:
        bbox2d = project_boxes_to_bbox2d(boxes7, calib, image_shape)
        loc, _, ry = box7_to_camera_label(boxes7, calib)
        alpha = ry - np.arctan2(loc[:, 0], loc[:, 2])
    else:
        bbox2d = np.tile([0.0, 0.0, 50.0, 50.0], (max(n, 1), 1))[:n]
    return Annotation(
        names=[CLASS_NAMES[c] for c in class_ids],
        boxes7=boxes7, bbox2d=bbox2d,
        truncated=np.zeros(n), occluded=np.zeros(n),
        alpha=alpha, scores=scores)


def project_boxes_to_bbox2d(boxes7: np.ndarray, calib,
                            image_shape=None) -> np.ndarray:
    """Image-plane AABB of each 3D box's 8 projected corners (the corners
    in float32, as the reference computes them)."""
    boxes7 = np.asarray(boxes7, np.float64).reshape(-1, 7)
    if not len(boxes7):
        return np.zeros((0, 4))
    corners = boxes3d_corners(boxes7)                          # [N, 8, 3]
    uvz = calib.velo_to_image(corners.reshape(-1, 3)).reshape(-1, 8, 3)
    u, v = uvz[..., 0], uvz[..., 1]
    bbox = np.stack([u.min(1), v.min(1), u.max(1), v.max(1)], axis=-1)
    if image_shape is not None:
        h, w = image_shape[0], image_shape[1]
        bbox[:, 0] = np.clip(bbox[:, 0], 0, w - 1.0)
        bbox[:, 2] = np.clip(bbox[:, 2], 0, w - 1.0)
        bbox[:, 1] = np.clip(bbox[:, 1], 0, h - 1.0)
        bbox[:, 3] = np.clip(bbox[:, 3], 0, h - 1.0)
    return bbox


# --------------------------------------------------------------------------
# Devkit core
# --------------------------------------------------------------------------

def image_box_overlap(boxes_a: np.ndarray, boxes_b: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """Axis-aligned 2D overlap [A, B]. criterion -1: IoU; 0: inter/area_a
    (the devkit's DontCare criterion)."""
    a = np.asarray(boxes_a, np.float64).reshape(-1, 4)
    b = np.asarray(boxes_b, np.float64).reshape(-1, 4)
    if not len(a) or not len(b):
        return np.zeros((len(a), len(b)))
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    if criterion == 0:
        denom = np.broadcast_to(area_a[:, None], inter.shape)
    else:
        area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        denom = area_a[:, None] + area_b[None, :] - inter
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _clean_data(gt: Annotation, det: Annotation, cls_name: str,
                difficulty: int):
    """Devkit clean_data: per-object validity for one class x difficulty.

    Returns (num_valid_gt, ignored_gt [G], ignored_det [D], dc_mask [G]):
    ignored codes: 0 = counted, 1 = ignored (no credit, no penalty),
    -1 = irrelevant (other class; invisible to matching).
    """
    similar = SIMILAR_CLASSES.get(cls_name, ())
    g = len(gt)
    ignored_gt = np.full(g, -1, np.int32)
    dc_mask = np.zeros(g, bool)
    num_valid = 0
    heights = gt.bbox2d[:, 3] - gt.bbox2d[:, 1]
    for i in range(g):
        name = gt.names[i]
        if name == "DontCare":
            dc_mask[i] = True
            continue
        if name == cls_name:
            valid_class = 1
        elif name in similar:
            valid_class = 0
        else:
            continue
        beyond_cap = (gt.occluded[i] > MAX_OCCLUSION[difficulty]
                      or gt.truncated[i] > MAX_TRUNCATION[difficulty]
                      or heights[i] <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not beyond_cap:
            ignored_gt[i] = 0
            num_valid += 1
        else:   # similar class, or right class beyond the difficulty cap
            ignored_gt[i] = 1
    d = len(det)
    ignored_det = np.full(d, -1, np.int32)
    det_heights = det.bbox2d[:, 3] - det.bbox2d[:, 1]
    for j in range(d):
        if det_heights[j] < MIN_HEIGHT[difficulty]:
            ignored_det[j] = 1
        elif det.names[j] == cls_name:
            ignored_det[j] = 0
    return num_valid, ignored_gt, ignored_det, dc_mask


def _collect_tp_scores(overlaps, dt_scores, ignored_gt, ignored_det,
                       min_overlap) -> np.ndarray:
    """Devkit pass 1 (compute_fp=False): scores of the detections that
    match each counted gt (highest-score overlapping det, greedy)."""
    assigned = np.zeros(len(dt_scores), bool)
    out = []
    for i in range(len(ignored_gt)):
        if ignored_gt[i] == -1:
            continue
        det_idx, best_score = -1, -np.inf
        for j in range(len(dt_scores)):
            if ignored_det[j] == -1 or assigned[j]:
                continue
            if overlaps[j, i] > min_overlap and dt_scores[j] > best_score:
                det_idx, best_score = j, dt_scores[j]
        if det_idx < 0:
            continue
        assigned[det_idx] = True
        if ignored_gt[i] == 0 and ignored_det[det_idx] == 0:
            out.append(best_score)
    return np.asarray(out, np.float64)


def _frame_statistics(overlaps, dt_scores, ignored_gt, ignored_det,
                      dc_overlap, min_overlap, thresh,
                      gt_alphas=None, dt_alphas=None):
    """Devkit pass 2 (compute_fp=True) at one score cutoff.

    overlaps: [D, G]; dc_overlap: [D, NDC] criterion-0 or None.
    Returns (tp, fp, fn, similarity_sum).
    """
    d = len(dt_scores)
    below = dt_scores < thresh
    assigned = np.zeros(d, bool)
    tp = fp = fn = 0
    sim = 0.0
    aos = gt_alphas is not None and dt_alphas is not None
    for i in range(len(ignored_gt)):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        max_overlap = 0.0
        assigned_ignored = False
        found = False
        for j in range(d):
            if ignored_det[j] == -1 or assigned[j] or below[j]:
                continue
            ov = overlaps[j, i]
            if ov <= min_overlap:
                continue
            if ignored_det[j] == 0 and (ov > max_overlap or assigned_ignored):
                max_overlap = ov
                det_idx = j
                found = True
                assigned_ignored = False
            elif ignored_det[j] == 1 and not found:
                det_idx = j
                found = True
                assigned_ignored = True
        if not found and ignored_gt[i] == 0:
            fn += 1
        elif found and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif found:
            tp += 1
            assigned[det_idx] = True
            if aos:
                delta = gt_alphas[i] - dt_alphas[det_idx]
                sim += (1.0 + np.cos(delta)) / 2.0
    stray = (~assigned) & (ignored_det == 0) & (~below)
    if dc_overlap is not None and dc_overlap.shape[1] and stray.any():
        # devkit: unmatched valid dets inside a DontCare region are not fp
        stray &= ~(dc_overlap > min_overlap).any(axis=1)
    fp = int(stray.sum())
    return tp, fp, fn, sim


def get_thresholds(tp_scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = N_SAMPLE_PTS) -> np.ndarray:
    """Devkit getThresholds: pick tp scores at ~1/(N-1) recall steps."""
    scores = np.sort(np.asarray(tp_scores, np.float64))[::-1]
    thresholds = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return np.asarray(thresholds, np.float64)


def _eval_cell(frames, cls_name: str, difficulty: int, metric: str,
               min_overlap: float, num_points: int, compute_aos: bool):
    """AP for one class x difficulty x metric cell.

    frames: list of dicts with keys gt, det, overlaps, dc_overlap.
    num_points: 40 (R40), 11 (R11), or 0 (exact area-under-PR).
    """
    cleaned = []
    total_gt = 0
    all_tp_scores = []
    for f in frames:
        num_valid, ig_gt, ig_det, dc_mask = _clean_data(
            f["gt"], f["det"], cls_name, difficulty)
        total_gt += num_valid
        dc_overlap = None
        if metric == "bbox" and dc_mask.any():
            dc_overlap = f["dc_overlap"][:, dc_mask]
        cleaned.append((f, ig_gt, ig_det, dc_overlap))
        all_tp_scores.append(_collect_tp_scores(
            f["overlaps"], f["det"].scores, ig_gt, ig_det, min_overlap))
    if total_gt == 0:
        return 0.0, 0.0
    tp_scores = np.concatenate(all_tp_scores)
    if num_points == 0:
        thresholds = np.sort(np.unique(tp_scores))[::-1]
    else:
        thresholds = get_thresholds(tp_scores, total_gt)
    if not len(thresholds):
        return 0.0, 0.0

    t = len(thresholds)
    tp = np.zeros(t)
    fp = np.zeros(t)
    fn = np.zeros(t)
    sim = np.zeros(t)
    for f, ig_gt, ig_det, dc_overlap in cleaned:
        aos_now = (compute_aos and metric == "bbox"
                   and f["gt"].alpha is not None
                   and f["det"].alpha is not None)
        stats = native.eval_statistics(
            f["overlaps"], f["det"].scores, ig_gt, ig_det, dc_overlap,
            min_overlap, thresholds,
            gt_alphas=f["gt"].alpha if aos_now else None,
            dt_alphas=f["det"].alpha if aos_now else None)
        tp += stats[0]
        fp += stats[1]
        fn += stats[2]
        sim += stats[3]

    precision = tp / np.maximum(tp + fp, 1e-12)
    orientation = sim / np.maximum(tp + fp, 1e-12)
    # monotone from the right (devkit)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    orientation = np.maximum.accumulate(orientation[::-1])[::-1]

    if num_points == 0:
        recall = tp / total_gt
        prev = np.concatenate([[0.0], recall[:-1]])
        ap = float(np.sum((recall - prev) * precision))
        aos_v = float(np.sum((recall - prev) * orientation))
        return ap, aos_v
    prec_full = np.zeros(N_SAMPLE_PTS)
    ori_full = np.zeros(N_SAMPLE_PTS)
    m = min(t, N_SAMPLE_PTS)
    prec_full[:m] = precision[:m]
    ori_full[:m] = orientation[:m]
    if num_points == 11:
        idx = np.arange(0, N_SAMPLE_PTS, 4)
    else:
        idx = np.arange(1, N_SAMPLE_PTS)
    return (float(prec_full[idx].mean()), float(ori_full[idx].mean()))


def evaluate_annotations(gt_annos: Sequence[Annotation],
                         det_annos: Sequence[Annotation],
                         metrics: Sequence[str] = ("3d", "bev"),
                         classes: Sequence[str] = CLASS_NAMES,
                         num_points: int = 40,
                         compute_aos: bool = False,
                         min_overlaps: Optional[Dict[str, float]] = None
                         ) -> Dict[str, float]:
    """Official-protocol evaluation over a split.

    Returns {"Car_3d_moderate": AP, ...} (fractions, not percent) for
    every class x difficulty x metric cell, plus "*_aos_*" cells when
    compute_aos and "bbox" in metrics.
    """
    if len(gt_annos) != len(det_annos):
        raise ValueError(f"{len(gt_annos)} ground-truth frames, "
                         f"{len(det_annos)} detection frames")
    results: Dict[str, float] = {}
    for metric in metrics:
        frames = []
        for gt, det in zip(gt_annos, det_annos):
            if metric == "bbox":
                overlaps = image_box_overlap(det.bbox2d, gt.bbox2d)
                # criterion-0 overlap vs every gt box; _eval_cell selects
                # the DontCare columns per class/difficulty
                dc_overlap = image_box_overlap(det.bbox2d, gt.bbox2d,
                                               criterion=0)
            elif metric == "bev":
                overlaps = native.rotated_iou_bev(
                    det.boxes7[:, [0, 1, 3, 4, 6]],
                    gt.boxes7[:, [0, 1, 3, 4, 6]])
                dc_overlap = None
            elif metric == "3d":
                overlaps = native.iou_3d(det.boxes7, gt.boxes7)
                dc_overlap = None
            else:
                raise ValueError(f"unknown metric {metric!r}")
            frames.append({"gt": gt, "det": det, "overlaps": overlaps,
                           "dc_overlap": dc_overlap})
        for cls_name in classes:
            if min_overlaps is not None:
                thr = min_overlaps[cls_name]
            elif metric == "bbox":
                thr = CLASS_IOU_THRESHOLDS_BBOX[cls_name]
            else:
                thr = CLASS_IOU_THRESHOLDS[cls_name]
            for di, dname in enumerate(DIFFICULTIES):
                ap, aos = _eval_cell(frames, cls_name, di, metric, thr,
                                     num_points, compute_aos)
                results[f"{cls_name}_{metric}_{dname}"] = ap
                if compute_aos and metric == "bbox":
                    results[f"{cls_name}_aos_{dname}"] = aos
    return results


# --------------------------------------------------------------------------
# Simplified (box7 + difficulty) API, kept for synthetic pipelines/tests
# --------------------------------------------------------------------------

# Difficulty-only callers reuse the devkit core by encoding the bucket
# as the occlusion level: with MAX_OCCLUSION=(0,1,2), a gt with
# occluded=d is beyond_cap at evaluated difficulty di exactly when
# d > di -- the "ignore gts harder than the evaluated difficulty"
# semantics. Heights alone cannot represent this (moderate and hard
# share MIN_HEIGHT=25, so a height-encoded diff-2 gt would wrongly count
# as valid at moderate). Difficulty -1 uses a short box (height 10 <=
# every MIN_HEIGHT) so it is ignored at all difficulties.
_IGNORE_HEIGHT = 10.0
_VALID_HEIGHT = 50.0


@dataclasses.dataclass
class FrameDetections:
    """Detections for one frame (one class or mixed; class ids given)."""

    boxes7: np.ndarray      # [D, 7]
    scores: np.ndarray      # [D]
    classes: np.ndarray     # [D] int32


@dataclasses.dataclass
class FrameGroundTruth:
    boxes7: np.ndarray      # [G, 7]
    classes: np.ndarray     # [G] int32
    difficulty: np.ndarray  # [G] int32 (0/1/2, -1 = ignore always)


def _gt_to_annotation(gt: FrameGroundTruth) -> Annotation:
    n = len(gt.boxes7)
    diffs = np.asarray(gt.difficulty, np.int32).reshape(-1)
    heights = np.where(diffs < 0, _IGNORE_HEIGHT, _VALID_HEIGHT)
    occluded = np.maximum(diffs, 0).astype(np.float64)
    bbox2d = np.zeros((n, 4))
    bbox2d[:, 3] = heights
    bbox2d[:, 2] = 50.0
    return Annotation(
        names=[CLASS_NAMES[c] for c in gt.classes],
        boxes7=np.asarray(gt.boxes7, np.float64).reshape(-1, 7),
        bbox2d=bbox2d, truncated=np.zeros(n), occluded=occluded)


def _det_to_annotation(det: FrameDetections) -> Annotation:
    return detection_annotation(det.boxes7, det.scores, det.classes)


def evaluate(gts: Sequence[FrameGroundTruth],
             dets: Sequence[FrameDetections],
             metric: str = "3d", num_points: int = 40
             ) -> Dict[str, float]:
    """Evaluate box7+difficulty detections over a split (devkit core).

    num_points: 40 (official R40), 11 (R11), 0 (exact area-under-PR; use
    for small synthetic fixtures where the 41-point grid quantizes AP).
    """
    return evaluate_annotations(
        [_gt_to_annotation(g) for g in gts],
        [_det_to_annotation(d) for d in dets],
        metrics=(metric,), num_points=num_points)
