"""Rotated NMS as iterated independent sets (torch), mirroring
`dcf.ops.nms.rotated_nms_parallel` with a precomputed IoU matrix."""

from __future__ import annotations

from typing import Tuple

import torch

from dcf_torch.utils import trace


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis with the reference's tie order:
    among equal values the lower index comes first (a stable descending
    sort; `torch.topk` leaves the order of ties unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def rotated_nms_parallel(iou: torch.Tensor, scores: torch.Tensor,
                         valid: torch.Tensor, iou_threshold: float,
                         max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS over a batch of independent candidate sets.

    Greedy NMS keeps a box iff no kept higher-scored box overlaps it.
    Each round keeps every live box with no live dominator and removes
    everything a newly kept box suppresses; every round keeps at least
    one box per non-empty set, so at most K rounds run, and the loop
    stops as soon as no box is live. Ties in score break by index, as
    argmax does.

    Args:
      iou: [..., K, K] IoU matrix; scores: [..., K]; valid: [..., K] bool.

    Returns:
      (indices [..., max_out] int64 into the K candidates, in descending
      score order; keep mask [..., max_out] bool).
    """
    K = iou.shape[-1]
    s = scores.to(torch.float32)
    idx = torch.arange(K, device=s.device)
    higher = (s[..., None, :] > s[..., :, None]) | (
        (s[..., None, :] == s[..., :, None]) & (idx[None, :] < idx[:, None]))
    overlap = iou > iou_threshold
    dominates = overlap & higher                   # [..., i, j]: j beats i
    live = valid.clone()
    keep = torch.zeros_like(valid)
    for _ in range(K):
        with trace.sync():
            any_live = bool(live.any())
        if not any_live:
            break
        trace.count("nms.rounds")
        has_live_dominator = (dominates & live[..., None, :]).any(dim=-1)
        is_max = live & ~has_live_dominator
        keep = keep | is_max
        suppressed = (overlap & is_max[..., None, :]).any(dim=-1)
        live = live & ~is_max & ~suppressed
    kept_scores = torch.where(keep, s, -torch.inf)
    top_scores, top_idx = top_k(kept_scores, max_out)
    return top_idx, top_scores > -torch.inf
