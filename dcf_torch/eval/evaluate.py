"""Split evaluation: inference over a dataset, then KITTI AP (mirrors
`dcf.eval.evaluate.run_eval`).

The model serves the frames in batches on its device; the detections
come back to the host once per batch, are filtered by score, optionally
written as KITTI result files, and scored by the devkit evaluator
(`dcf_torch.eval.kitti_eval`, numpy on the host).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dcf_torch.config import Config
from dcf_torch.data.kitti import CLASS_NAMES, write_kitti_result
from dcf_torch.data.preprocess import frame_to_example, stack_examples
from dcf_torch.eval.inference import make_inference_fn, to_host
from dcf_torch.eval.kitti_eval import (Annotation, annotation_from_frame,
                                       detection_annotation,
                                       evaluate_annotations)
from dcf_torch.models.detector import ContFuseDetector


def detect(cfg: Config, infer: Callable, dataset,
           result_dir: Optional[str] = None,
           score_threshold: Optional[float] = None,
           num_frames: Optional[int] = None, batch_size: int = 8
           ) -> Tuple[List[Annotation], List[Annotation]]:
    """Serve the first `num_frames` frames of `dataset` through `infer`
    (`make_inference_fn`) in batches of `batch_size`: the last batch is
    padded by repeating its first frame, and the padding is dropped.
    Returns the ground truth and the detections (score >= the threshold,
    `cfg.head.score_threshold` by default) as devkit annotations, one
    per frame; with `result_dir`, also writes `<frame_id>.txt` there."""
    thr = (score_threshold if score_threshold is not None
           else cfg.head.score_threshold)
    if result_dir:
        os.makedirs(result_dir, exist_ok=True)
    gts: List[Annotation] = []
    dets: List[Annotation] = []
    n = len(dataset) if num_frames is None else min(num_frames, len(dataset))
    bs = max(1, min(batch_size, n))
    for start in range(0, n, bs):
        frames = [dataset[i] for i in range(start, min(start + bs, n))]
        padded = frames + [frames[0]] * (bs - len(frames))
        out = to_host(infer(stack_examples(
            [frame_to_example(f, cfg) for f in padded])))
        for j, frame in enumerate(frames):
            keep = out["valid"][j] & (out["scores"][j] >= thr)
            boxes = out["boxes"][j][keep]
            scores = out["scores"][j][keep]
            classes = out["classes"][j][keep]
            dets.append(detection_annotation(
                boxes, scores, classes, calib=frame.calib,
                image_shape=frame.image.shape))
            gts.append(annotation_from_frame(frame))
            if result_dir:
                write_kitti_result(
                    os.path.join(result_dir, frame.frame_id + ".txt"),
                    [CLASS_NAMES[c] for c in classes], boxes, scores,
                    frame.calib, image_shape=frame.image.shape)
    return gts, dets


def run_eval(cfg: Config, model: ContFuseDetector, dataset,
             result_dir: Optional[str] = None,
             score_threshold: Optional[float] = None,
             num_frames: Optional[int] = None,
             num_points: int = 40,
             batch_size: int = 8,
             metrics: Sequence[str] = ("3d", "bev"),
             infer: Optional[Callable] = None,
             device="cuda") -> Dict[str, float]:
    """Evaluate `model` over a dataset; returns the AP dict
    (`evaluate_annotations`: {"Car_3d_moderate": AP, ...}).

    num_points: 40 = official R40, 11 = legacy R11, 0 = exact
    area-under-PR (for small synthetic splits, where the devkit's
    41-point recall grid quantizes AP to ~k/41).

    infer: `make_inference_fn(cfg, model, device)`, built once and passed
    to every call that evaluates the same model (each build moves the
    model and builds the anchors); by default one is built here on
    `device`.
    """
    if infer is None:
        infer = make_inference_fn(cfg, model, device=device)
    gts, dets = detect(cfg, infer, dataset, result_dir=result_dir,
                       score_threshold=score_threshold,
                       num_frames=num_frames, batch_size=batch_size)
    return evaluate_annotations(gts, dets, metrics=metrics,
                                num_points=num_points)
