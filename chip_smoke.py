#!/usr/bin/env python3
"""Run the PyTorch port (`dcf_torch`) end to end on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printed on its own line with the seconds elapsed:
  1. the card's name and power limit (nvidia-smi);
  2. the CUDA kernels built with nvcc from `dcf_torch/csrc`;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes: the fusion forward at all four scales of one
     synthetic frame, the rotated clip on 196,608 random box pairs plus
     hard cases; max error, kernel ms and plain ms (CUDA events);
  4. a small-input reference: `tiny_config` in float32 served on the card
     (kernels) and on the CPU (plain versions) with the same weights;
  5. serving: `multi_scale_config()` at full width in bf16 with seeded
     random weights, 8 synthetic frames at batch 1 through
     `make_inference_fn`, checking finite outputs and that the main path
     launched the fusion kernel 4 times and the clip kernel once per
     frame; p50 / p95 ms.

Then one JSON line describing every kernel, and last the line
`{"ok": true, "device": {...}}`. Any failure raises, and the script
exits non-zero without a result; so it does without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

T0 = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12            # outside the tensor cores

FUSION_TOL = 1e-5                 # x max|out|: same arithmetic, same order
CLIP_TOL = 1e-4                   # x (1 + area): cosf/sinf may differ by an ulp
TINY_ATOL, TINY_RTOL = 2e-4, 2e-3  # x max|pred|; tests/test_oracle_e2e.py


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after 2 warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fusion_inputs(cfg, example, device, rng):
    """Per scale: the fusion kernel's inputs as the main path builds them
    from one frame (bins from the real points and ranks), with seeded
    random z1 / Wg / bg."""
    import torch
    from dcf_torch.ops.fusion import quantize_payload_xyz
    from dcf_torch.ops.knn import bin_points_dense
    vox, fus = cfg.voxel, cfg.fusion
    pts = torch.from_numpy(example["points"])[None].to(device)
    rank = torch.from_numpy(example["fusion_rank"])[None].to(device)
    P, hid = pts.shape[1], fus.hidden_dim
    gidx = torch.arange(P, dtype=torch.float32, device=device)
    payload = torch.cat([pts[..., :3], gidx[None, :, None]], dim=-1)
    out = []
    for si, s in enumerate(cfg.backbone.fusion_strides):
        H, W = vox.grid_x // s, vox.grid_y // s
        cell = vox.voxel_size * s
        origin = (vox.x_min, vox.y_min)
        bins = bin_points_dense(payload, rank[:, si] >= 0, origin, cell,
                                (H, W), fus.bin_capacity)
        data = quantize_payload_xyz(bins.data, origin, cell).contiguous()
        z1 = torch.from_numpy(rng.normal(size=(1, P, hid)).astype(
            np.float32)).to(device)
        wgt = torch.from_numpy((rng.normal(size=(hid, 4)) * 0.3).astype(
            np.float32)).to(device)
        bg = torch.from_numpy((rng.normal(size=hid) * 0.1).astype(
            np.float32)).to(device)
        out.append((s, (data, bins.valid.contiguous(), z1, wgt, bg, origin,
                        cell, fus.num_neighbors, fus.search_radius_cells)))
    return out


def check_fusion(cfg, example, device):
    import torch
    import torch.nn.functional as F
    from dcf_torch.ops.fusion import fused_fusion, fused_fusion_plain
    rng = np.random.default_rng(0)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0,
           "ops": 0.0, "err": 0.0}
    for s, args in fusion_inputs(cfg, example, device, rng):
        got = fused_fusion(*args)
        want = fused_fusion_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"fusion s{s}: non-finite kernel output")
        err = (got - want).abs().max().item()
        scale = max(want.abs().max().item(), 1.0)
        if err > FUSION_TOL * scale:
            raise RuntimeError(f"fusion s{s}: kernel vs plain max|err| {err} "
                               f"> {FUSION_TOL} x {scale}")
        data, valid, z1, wgt, bg, _, _, k, r = args
        ms = cuda_ms(lambda: fused_fusion(*args), 50)
        plain = cuda_ms(lambda: fused_fusion_plain(*args), 3)
        # bytes: every input read once, the output written once;
        # operations: what this data needs -- 5 per valid candidate in a
        # window (2 sub, 2 mul, 1 add) and, per selected pair, 4 for the
        # geometry (2 sub, min, sqrt) plus 11 per hidden channel (4 mul,
        # 3 add, + bias, + z1, relu, + accumulate)
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (data, valid, z1, wgt, bg, got))
        per_cell = valid.sum(-1, dtype=torch.float32)[:, None]
        win = 2 * r + 1
        cands = F.conv2d(F.pad(per_cell, (r, r, r, r)),
                         torch.ones((1, 1, win, win), device=device)).sum()
        pairs = got[..., -1].sum()
        hid = z1.shape[-1]
        n_ops = 5 * cands.item() + pairs.item() * (4 + 11 * hid)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        log(f"fusion s{s}: {tuple(data.shape[1:3])} px, max|err| {err:.3g} "
            f"(scale {scale:.3g}), kernel {ms:.4f} ms, plain {plain:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {int(pairs.item())} pairs")
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", b_ms),
                       ("bytes", n_bytes), ("ops", n_ops)):
            tot[key] += v
        tot["err"] = max(tot["err"], err)
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"])
    return {"name": "fusion_fwd", "route": "cuda",
            "source": "dcf_torch/csrc/fusion_fwd.cu",
            "replaces": "dcf/ops/pallas/fusion_kernel.py:765",
            "max_abs_err": tot["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


# (a, b) box pairs (x, y, dx, dy, yaw) on the clip's edge cases, and the
# areas geometry fixes. The zero-area pairs are held to the plain version
# only: a box clipped by a degenerate box keeps its whole area there, as
# in the reference.
CLIP_HARD = np.array([
    [[0, 0, 2, 2, 0], [0, 0, 2, 2, 0]],                 # identical
    [[0, 0, 2, 2, 0.3], [10, 10, 2, 2, 0.3]],           # disjoint
    [[0, 0, 10, 10, 0.2], [0, 0, 1, 1, 1.0]],           # b inside a
    [[0, 0, 1, 1, 1.0], [0, 0, 10, 10, 0.2]],           # a inside b
    [[0, 0, 2, 2, 0], [0, 0, 2, 2, np.pi / 4]],         # 45 degrees
    [[1, 2, 4, 1, 0.5], [1, 2, 4, 1, 0.5 + np.pi / 2]],  # 90 degrees
    [[0, 0, 0, 0, 0], [0, 0, 2, 2, 0]],                 # zero-area a
    [[0, 0, 2, 2, 0], [0, 0, 0, 0, 0]],                 # zero-area b
    [[0, 0, 3, 0, 0.7], [0, 0, 2, 2, 0]],               # degenerate a
    [[1, 0, 2, 2, 0], [0, 0, 2, 2, 0]],                 # shared edges
    [[40, -5, 3.9, 1.6, 2.0], [40.5, -5.2, 3.9, 1.6, 2.1]],  # far, tilted
], np.float32)
CLIP_HARD_AREAS = {0: 4.0, 1: 0.0, 2: 1.0, 3: 1.0, 4: 8 * (2 ** 0.5 - 1),
                   5: 1.0, 9: 2.0}


def clip_pairs(device, n: int):
    """n box pairs: random plausible boxes, then CLIP_HARD."""
    import torch
    rng = np.random.default_rng(1)

    def boxes(m):
        b = np.zeros((m, 5), np.float32)
        b[:, :2] = rng.uniform(-4, 4, (m, 2)) + np.array([30.0, 0.0])
        b[:, 2:4] = rng.uniform(0.3, 5.0, (m, 2))
        b[:, 4] = rng.uniform(-np.pi, np.pi, m)
        return b
    m = n - len(CLIP_HARD)
    a = np.concatenate([boxes(m), CLIP_HARD[:, 0]])
    b = np.concatenate([boxes(m), CLIP_HARD[:, 1]])
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def check_clip_hard(got) -> None:
    """`got`: the areas of clip_pairs' last len(CLIP_HARD) pairs."""
    hard = got[-len(CLIP_HARD):].tolist()
    for i, area in CLIP_HARD_AREAS.items():
        if abs(hard[i] - area) > 1e-4:
            raise RuntimeError(f"clip hard case {i}: {hard[i]} != {area}")


def clip_ops(a, b) -> float:
    """f32 operations that the clip of these pairs needs when it works on
    live vertices only (a convex polygon clipped by a half-plane gains at
    most one vertex, so 4, <=5, <=6, <=7 inputs): per pair 76 for the
    corners of both boxes (cos, sin, 4 half-extents, 8 x 4); per stage 2
    for the edge, 6 per live input vertex (side test: 2 sub, 2 mul, 1 sub,
    compare) and 8 per edge crossing (denominator, divide, 2 x (sub, mul,
    add)); 4 per live vertex of the last polygon for the shoelace, plus 2.
    The live vertices are counted on the plain clip's doubled buffers:
    filled slots are copies of a live vertex and count once."""
    import torch
    from dcf_torch.geometry.boxes import (_clip_by_edge, _cross2,
                                          box_corners_bev)
    poly, cb = box_corners_bev(a), box_corners_bev(b)
    live = torch.ones(poly.shape[:-1], dtype=torch.bool, device=a.device)
    n_ops = 76.0 * a.shape[0]
    for k in range(4):
        p1, p2 = cb[:, None, k], cb[:, None, (k + 1) % 4]
        cur_in = _cross2(p1, p2, poly) >= 0.0
        prev_in = torch.roll(cur_in, 1, dims=-1)
        crossing = cur_in != prev_in
        n_ops += 2.0 * a.shape[0] + 6.0 * live.sum().item() \
            + 8.0 * crossing.sum().item()
        live = torch.stack([crossing, cur_in & live], dim=-1).flatten(-2)
        if k < 3:
            poly, _ = _clip_by_edge(poly, p1[:, 0], p2[:, 0])
    return n_ops + 4.0 * live.sum().item() + 2.0 * a.shape[0]


def check_clip(device):
    import torch
    from dcf_torch.ops.clip import (rotated_intersection_area_pairs,
                                    rotated_intersection_area_pairs_plain)
    n = 3 * 256 * 256                   # the NMS pairs of one frame
    a, b = clip_pairs(device, n)
    got = rotated_intersection_area_pairs(a, b)
    want = rotated_intersection_area_pairs_plain(a, b)
    torch.cuda.synchronize()
    err = (got - want).abs()
    bad = err > CLIP_TOL * (1 + want.abs())
    if bad.any() or not torch.isfinite(got).all():
        raise RuntimeError(f"clip: {int(bad.sum())} pairs disagree, "
                           f"max|err| {err.max().item()}")
    check_clip_hard(got)
    ms = cuda_ms(lambda: rotated_intersection_area_pairs(a, b), 50)
    plain = cuda_ms(lambda: rotated_intersection_area_pairs_plain(a, b), 3)
    # bytes: 2 x [N, 5] f32 in, [N] f32 out; operations: clip_ops
    n_bytes = 2 * a.numel() * 4 + got.numel() * 4
    n_ops = clip_ops(a, b)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    log(f"clip: {n} pairs, max|err| {err.max().item():.3g}, hard "
        f"{got[-len(CLIP_HARD):].tolist()}, "
        f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {n_ops / n:.1f} operations per pair)")
    return {"name": "clip_pairs", "route": "cuda",
            "source": "dcf_torch/csrc/clip.cu",
            "replaces": "dcf/ops/pallas/clip_kernel.py:42",
            "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_tiny_reference():
    """tiny_config in float32: the card (kernels) against the CPU (plain
    versions), same weights, same frame."""
    import dataclasses
    import torch
    from dcf_torch.config import tiny_config
    from dcf_torch.data.preprocess import frame_to_example, stack_examples
    from dcf_torch.data.synthetic import make_frame
    from dcf_torch.eval.inference import batch_to_device, make_inference_fn
    from dcf_torch.ops.clip import rotated_intersection_area_pairs
    from dcf_torch.ops.fusion import fused_fusion
    from dcf_torch.params import init_params
    cfg = tiny_config(True)
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="float32"))
    batch = stack_examples([frame_to_example(make_frame(seed=0), cfg)])
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # a float32 reference
    try:
        with torch.no_grad():
            want = cpu(batch_to_device(batch, "cpu"))
            got = gpu(batch_to_device(batch, "cuda"))
        dets_cpu = make_inference_fn(cfg, cpu, device="cpu")(batch)
        launched = (fused_fusion.launches,
                    rotated_intersection_area_pairs.launches)
        dets_gpu = make_inference_fn(cfg, gpu, device="cuda")(batch)
        launched = (fused_fusion.launches - launched[0],
                    rotated_intersection_area_pairs.launches - launched[1])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for name in ("cls", "reg", "dir"):
        g, w = got[name].cpu().double(), want[name].double()
        scale = max(w.abs().max().item(), 1e-3)
        if not torch.allclose(g, w, atol=TINY_ATOL * scale, rtol=TINY_RTOL):
            raise RuntimeError(f"tiny {name}: card vs CPU max|err| "
                               f"{(g - w).abs().max().item()}")
    if launched != (4, 1):
        raise RuntimeError(f"tiny: launched {launched} (fusion, clip), "
                           f"expected (4, 1)")
    v = dets_cpu["valid"]
    if not (torch.equal(dets_gpu["valid"].cpu(), v)
            and torch.equal(dets_gpu["classes"].cpu()[v], dets_cpu["classes"][v])
            and torch.allclose(dets_gpu["boxes"].cpu()[v],
                               dets_cpu["boxes"][v], atol=1e-3)):
        raise RuntimeError("tiny detections: card and CPU disagree")
    log(f"tiny reference: forward and {int(v.sum())} detections agree "
        f"(card vs CPU, float32)")


def serve(device):
    import torch
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data.preprocess import frame_to_example, stack_examples
    from dcf_torch.data.synthetic import make_varied_frame
    from dcf_torch.eval.inference import make_inference_fn
    from dcf_torch.ops.clip import rotated_intersection_area_pairs
    from dcf_torch.ops.fusion import fused_fusion
    from dcf_torch.params import init_params
    cfg = multi_scale_config()
    model = init_params(cfg, torch.Generator().manual_seed(0), device=device)
    infer = make_inference_fn(cfg, model, device=device)
    batches = [stack_examples([frame_to_example(make_varied_frame(seed=s),
                                                cfg)]) for s in range(9)]
    log(f"serving: multi_scale_config, {cfg.backbone.dtype}, "
        f"{sum(p.numel() for p in model.parameters())} params, "
        f"{len(batches) - 1} frames built")
    infer(batches[-1])                              # warm-up frame
    torch.cuda.synchronize()

    fused_fusion.launches = 0
    rotated_intersection_area_pairs.launches = 0
    times, n_valid = [], 0
    D = cfg.head.max_detections
    for batch in batches[:-1]:
        t = time.perf_counter()
        dets = infer(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if tuple(dets["boxes"].shape) != (1, D, 7) or \
                not torch.isfinite(dets["boxes"]).all() or \
                not torch.isfinite(dets["scores"]).all():
            raise RuntimeError("serving: malformed or non-finite detections")
        n_valid += int(dets["valid"].sum())
    launches = {"fusion_fwd": fused_fusion.launches,
                "clip_pairs": rotated_intersection_area_pairs.launches}
    n = len(times)
    expect = {"fusion_fwd": len(cfg.backbone.fusion_strides) * n,
              "clip_pairs": n}
    if launches != expect:
        raise RuntimeError(f"serving launches {launches} != {expect}")
    log(f"serving: {n} frames at B=1, p50 {np.percentile(times, 50):.3f} ms, "
        f"p95 {np.percentile(times, 95):.3f} ms, per frame "
        f"{[round(t, 3) for t in times]} ms, {n_valid} valid detections, "
        f"launches {launches}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import dcf_torch
    if not os.path.abspath(dcf_torch.__file__).startswith(HERE + os.sep):
        raise RuntimeError(f"dcf_torch imported from {dcf_torch.__file__}, "
                           f"not from this checkout ({HERE})")
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data.preprocess import frame_to_example
    from dcf_torch.data.synthetic import make_varied_frame
    from dcf_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s)")

    t = time.time()
    ptxas = _cuda.build(verbose=True)
    _cuda.library()
    log(f"build: nvcc over {len(_cuda.sources())} sources in "
        f"{time.time() - t:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("    " + line.strip(), flush=True)

    device = torch.device("cuda")
    cfg = multi_scale_config()
    example = frame_to_example(make_varied_frame(seed=3), cfg)
    kernels = [check_fusion(cfg, example, device), check_clip(device)]
    check_tiny_reference()
    launches = serve(device)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
