"""Faults planted under a run's timed path, to show that `correct` comes
out false: the tests run them at a small size on the CPU, `readings.py`
at the cell's size on the card. Each returns what it wraps."""

from __future__ import annotations

import torch


def altered_answer(inference):
    """Serving: every valid detection's box moved 0.5 m along x where the
    detections are produced."""
    decode = inference.decode_and_nms

    def altered(*a, **k):
        out = decode(*a, **k)
        boxes = out["boxes"].clone()
        boxes[..., 0] += torch.where(out["valid"], 0.5, 0.0)
        return {**out, "boxes": boxes}
    inference.decode_and_nms = altered


def half_batch(step):
    """Training: the step sees the first half of each batch only, its
    loss the mean over that half."""
    def wrapped(state, batch, pack):
        half = batch["points"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()}, pack)
    return wrapped


def state_unchanged(step):
    """Training: the step returns its state as it found it."""
    def wrapped(state, batch, pack):
        params = [p.detach().clone() for p in state.model.parameters()]
        state, metrics = step(state, batch, pack)
        with torch.no_grad():
            for p, old in zip(state.model.parameters(), params):
                p.copy_(old)
        return state, metrics
    return wrapped


SERVE = {"altered_answer": altered_answer}
TRAIN = {"half_batch": half_batch, "state_unchanged": state_unchanged}
