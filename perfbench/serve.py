"""Serving cells: one closed-loop stream of raw frames through the port's
serving path, and the comparison with the plain reference.

A frame's latency runs from handing over the raw frame (sweep, image,
calibration in memory) to its detections on the host:
`frame_to_example` -> `stack_examples` -> `make_inference_fn(cfg,
model)(batch)` -> `to_host`. The next frame is sent when the last
detections are back.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from perfbench import registry
from perfbench import spans as spans_mod
from perfbench import trace as trace_mod
from perfbench import traffic_gen, weights as weights_mod
from perfbench.reference import config as ref_config
from perfbench.reference.data import preprocess as ref_pre
from perfbench.reference.models import anchors as ref_anchors
from perfbench.reference.models import detector as ref_detector
from perfbench.reference.models import head as ref_head


MIX_KEYS = ("mode", "batch", "pool", "generator", "warmup_frames",
            "check_frames", "profile_s")


def check_mix(t: Dict) -> None:
    """A serving mix has just the keys `run` reads, and batch 1: one
    closed-loop stream at B=1 is all that `run` serves."""
    registry.check_keys(t, MIX_KEYS, "serve mix")
    if t["batch"] != 1:
        raise ValueError(f"serve mix: batch {t['batch']}; run serves one "
                         f"closed-loop stream at batch 1")


def program_frame(frame):
    """The program's own Frame and Calibration holding a copy of a
    generated frame's arrays."""
    from dcf_torch.data.synthetic import Frame
    from dcf_torch.geometry.calib import Calibration
    c = frame.calib
    return Frame(frame_id=frame.frame_id, points=frame.points.copy(),
                 image=frame.image.copy(),
                 calib=Calibration(c.P2, c.R0[:3, :3], c.V2C[:3]),
                 boxes=frame.boxes.copy(), labels=frame.labels.copy(),
                 difficulty=frame.difficulty.copy(), names=list(frame.names),
                 truncated=frame.truncated.copy(),
                 occluded=frame.occluded.copy(), alpha=frame.alpha.copy(),
                 bbox2d=frame.bbox2d.copy())


def roi_points(frame, vox) -> int:
    p = frame.points
    return int(((p[:, 0] >= vox.x_min) & (p[:, 0] < vox.x_max)
                & (p[:, 1] >= vox.y_min) & (p[:, 1] < vox.y_max)
                & (p[:, 2] >= vox.z_min) & (p[:, 2] < vox.z_max)).sum())


def check_set(pool_ref, vox, n: int, seed: int) -> List[int]:
    """Pool slots whose served frames are compared: drawn from the seed,
    with the frame of the most ROI points among them."""
    largest = max(range(len(pool_ref)),
                  key=lambda j: roi_points(pool_ref[j], vox))
    rng = np.random.default_rng([11, seed])
    others = [j for j in rng.permutation(len(pool_ref)) if j != largest]
    return sorted([largest] + [int(j) for j in others[:n - 1]])


def _fusion_bytes(a, out):
    """Bytes the fusion forward's work needs: the valid mask, the payload
    of the valid slots (16 B), the z1 rows of the binned points, wgt, bg
    and the output, each once."""
    data, valid, z1, wgt, bg = a[:5]
    n = valid.sum()
    hid = z1.shape[-1]
    return (valid.numel() + (16 + 4 * hid) * n
            + 4 * (wgt.numel() + bg.numel() + out.numel()))


def _clip_bytes(a, out):
    """Two [N, 5] float32 inputs and the [N] float32 output."""
    return 4 * (a[0].numel() + a[1].numel() + out.numel())


def run(env) -> Dict:
    """Set up, warm up, serve for `env.seconds`, and return what the run
    measured and captured (program state freed)."""
    import dcf_torch.eval.inference as inference
    import dcf_torch.models.fusion as pfusion
    import dcf_torch.models.head as phead
    from dcf_torch.config import Config
    from dcf_torch.data.preprocess import frame_to_example, stack_examples
    from dcf_torch.models.detector import ContFuseDetector

    t = env.traffic
    check_mix(t)
    cfg = Config.from_json(env.config_json)
    ref_cfg = ref_config.Config.from_json(env.config_json)
    pool_ref = traffic_gen.make_pool(t["generator"], t["pool"], env.seed)
    pool = [program_frame(f) for f in pool_ref]
    checked = set(check_set(pool_ref, ref_cfg.voxel, t["check_frames"],
                            env.seed))
    with torch.device("meta"):
        meta = ref_detector.ContFuseDetector(ref_cfg)
    w = weights_mod.make_weights(meta, env.seed, env.device)
    with torch.device(env.device):
        model = ContFuseDetector(cfg)
    weights_mod.load(model, w)
    infer = inference.make_inference_fn(cfg, model, env.device)

    sp = spans_mod.Spans(device_spans=env.trace)
    ranges = trace_mod.OpRanges()
    captured: Dict[int, Dict] = {}
    state = {"capture": False, "maps": None}
    saved = (inference.flatten_predictions, inference.decode_and_nms,
             pfusion.fused_fusion, phead.rotated_intersection_area_pairs)

    def flatten_capture(preds, c):
        if state["capture"]:
            state["maps"] = preds
        return saved[0](preds, c)
    inference.flatten_predictions = flatten_capture
    if env.fault is not None:
        env.fault(inference)
    if env.trace:
        sp.module(model, "forward")
        if cfg.with_camera:
            sp.module(model.image_backbone, "image_backbone")
        for name, child in model.named_children():
            if name.startswith("fusion_s"):
                sp.module(child, "fusion")
        inference.decode_and_nms = sp.wrap(inference.decode_and_nms,
                                           "decode_nms")
        pfusion.fused_fusion = ranges.wrap(saved[2], "fusion_fwd",
                                           _fusion_bytes)
        phead.rotated_intersection_area_pairs = ranges.wrap(
            saved[3], "clip", _clip_bytes)
        trace_mod.Profile.warm(env.device)
    sync = (torch.cuda.synchronize if env.device.type == "cuda"
            else (lambda: None))

    def serve(frame):
        t0 = spans_mod.host_clock()
        ex = frame_to_example(frame, cfg)
        batch = stack_examples([ex])
        t1 = spans_mod.host_clock()
        dets = inference.to_host(infer(batch))
        return ex, dets, t1 - t0, spans_mod.host_clock() - t0

    try:
        for i in range(t["warmup_frames"]):
            serve(pool[i % len(pool)])
        sync()
        sp.events.clear()
        sp.host.clear()
        prof = trace_mod.Profile(env.tmpdir) if env.trace else None
        latency = []
        t_start = spans_mod.host_clock()
        env.mark_window_start()
        i = 0
        while True:
            j = i % len(pool)
            state["capture"] = j in checked and j not in captured
            ex, dets, prep_s, frame_s = serve(pool[j])
            if state["capture"]:
                captured[j] = {"example": ex, "maps": state["maps"],
                               "dets": dets}
                state["maps"] = None
            latency.append(frame_s)
            sp.add_host("preprocess", prep_s)
            now = spans_mod.host_clock()
            i += 1
            if now - t_start >= env.seconds:
                break
            if prof is not None and not ranges.active and \
                    now - t_start >= env.seconds - t["profile_s"]:
                prof.start()
                ranges.active = True
                n_before = i
        window_s = spans_mod.host_clock() - t_start
        profile = None
        if prof is not None and ranges.active:
            prof.stop()
            ranges.active = False
            profile = prof.reduce()
            profile["frames"] = i - n_before
        device_ms = sp.device_ms() if env.trace else {}
        for j in sorted(checked - set(captured)):
            # a window shorter than one pass over the pool (CPU tests):
            # the checked frames it missed are served after it, untimed
            state["capture"] = True
            ex, dets, _, _ = serve(pool[j])
            captured[j] = {"example": ex, "maps": state["maps"],
                           "dets": dets}
        memory_peak = (torch.cuda.max_memory_allocated(env.device)
                       if env.device.type == "cuda" else 0)
    finally:
        (inference.flatten_predictions, inference.decode_and_nms,
         pfusion.fused_fusion, phead.rotated_intersection_area_pairs) = saved
        sp.close()
    for c in captured.values():
        c["maps"] = {k: v.detach() for k, v in c["maps"].items()}
    del model, infer
    gc.collect()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    lat_ms = np.asarray(latency) * 1e3
    e2e = {"frame_ms_p50": float(np.percentile(lat_ms, 50)),
           "frame_ms_p95": float(np.percentile(lat_ms, 95))}
    return {"e2e": e2e, "attempted": i, "failed": 0,
            "window_s": window_s, "memory_peak": memory_peak,
            "spans": {"device_ms": device_ms, "host_s": dict(sp.host),
                      "frames": i},
            "profile": profile, "ranges": ranges,
            "captured": captured, "pool_ref": pool_ref, "weights": w,
            "ref_cfg": ref_cfg}


def rel_err(p: torch.Tensor, r: torch.Tensor) -> float:
    """RMS of the difference over the reference's standard deviation."""
    p, r = p.to(torch.float64), r.to(torch.float64)
    return float((p - r).pow(2).mean().sqrt() / r.std().clamp(min=1e-30))


def _reference_model(cfg, weights, device, quant: str = "off"):
    """The float32 reference detector (TF32 off), or with its convs
    rounded through float8 (`quant="fp8"`), holding the run's weights."""
    import dataclasses
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="float32", quant_mode=quant))
    with torch.device(device):
        model = ref_detector.ContFuseDetector(cfg)
    weights_mod.load(model, weights)
    return model.eval(), cfg


def compare(run_out: Dict, device, control: bool = False
            ) -> Dict[str, float]:
    """The numbers compared with the reference, over the checked frames:
      prep_diff   elements of the program's example arrays that differ
                  from the reference's preprocessing of the same frame;
      head_err    the worst head map's RMS error against the float32
                  reference forward (TF32 off) on the reference's own
                  example, over the map's standard deviation;
      dets_diff   detection slots that differ from the reference's
                  decode and NMS of the program's own head maps.
    With `control`, the reference with its convs rounded through float8
    takes the program's place: its head maps are judged, on its own
    examples and through the reference's decode (prep_diff and dets_diff
    are then 0 by construction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, cfg32 = _reference_model(run_out["ref_cfg"], run_out["weights"],
                                    device)
    low = (_reference_model(run_out["ref_cfg"], run_out["weights"], device,
                            "fp8")[0] if control else None)
    anchors, classes, _, _ = ref_anchors.generate_anchors(cfg32)
    anchors = torch.from_numpy(anchors).to(device)
    classes = torch.from_numpy(classes).to(device)
    prep_diff, head_err, dets_diff = 0, 0.0, 0
    with torch.no_grad():
        for j, cap in sorted(run_out["captured"].items()):
            ex = ref_pre.frame_to_example(run_out["pool_ref"][j], cfg32)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v[None])).to(
                device) for k, v in ex.items()}
            maps = model(batch)
            if low is not None:
                got = low(batch)
                for k, v in maps.items():
                    head_err = max(head_err, rel_err(got[k], v))
                continue
            for k, v in ex.items():
                g = cap["example"][k]
                if g.shape != v.shape or g.dtype != v.dtype:
                    prep_diff += v.size
                else:
                    prep_diff += int((g != v).sum())
            for k, v in maps.items():
                head_err = max(head_err, rel_err(cap["maps"][k], v))
            flat = ref_head.flatten_predictions(
                {k: v.to(torch.float32) for k, v in cap["maps"].items()},
                cfg32)
            want = ref_head.decode_and_nms(flat, anchors, classes, cfg32)
            dets_diff += _dets_diff(cap["dets"], want)
    return {"prep_diff": float(prep_diff), "head_err": head_err,
            "dets_diff": float(dets_diff)}


def _dets_diff(got: Dict[str, np.ndarray], want: Dict[str, torch.Tensor]
               ) -> int:
    """Detection slots where validity, class, score or box differ (boxes
    by more than 1e-4 relative, scores by more than 1e-6)."""
    w = {k: v.cpu().numpy() for k, v in want.items()}
    bad = got["valid"] != w["valid"]
    both = got["valid"] & w["valid"]
    bad |= both & (got["classes"] != w["classes"])
    bad |= both & (np.abs(got["scores"] - w["scores"]) > 1e-6)
    bad |= both & (np.abs(got["boxes"] - w["boxes"])
                   > 1e-4 * (1 + np.abs(w["boxes"]))).any(-1)
    return int(bad.sum())
