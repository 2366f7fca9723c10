#!/usr/bin/env python3
"""Run the PyTorch port (`dcf_torch`) end to end on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printed on its own line with the seconds elapsed:
  1. the card's name and power limit (nvidia-smi);
  2. the CUDA kernels built from `dcf_torch/csrc`, one nvcc process per
     source, all at once;
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes: the fusion forward at all four scales of one
     synthetic frame, bit-equal with and without the stash, with its
     launch shape (lanes per pixel, tile) and its ms with the stash per
     scale, the fusion backward at the same four scales (its
     stash from the kernel forward, checked equal to the plain one's
     selections; a seeded cotangent; two launches bit-identical, d_z1
     bit-equal to the plain version run on the CPU, all outputs within
     a tolerance that follows from the length of each float32 sum of
     the plain version on the card; ms per scale beside the earlier
     kernel's total), the rotated clip on 196,608 random box pairs plus
     hard cases, with the count of pairs that differ from the plain
     version at all; max error; kernel ms (device time: 20 calls
     captured in a CUDA graph, replayed between CUDA events, so the
     host's cost per launch is out of it; the backward's entry point
     after the zero fill of its counts, its outputs and scratch
     allocated before) and plain ms
     (CUDA events around back-to-back calls); the bound of each, from
     the bytes and operations this run's data needs;
  4. a small-input reference: `tiny_config` in float32 served on the card
     (kernels) and on the CPU (plain versions) with the same weights;
  5. a small-input training reference: one `tiny_config` float32 train
     step on the card and on the CPU from the same weights and batch;
     loss, metrics and every gradient leaf agree, and `img_proj`,
     `geo_kernel`, `geo_bias` and the image stem get gradients on the card
     (their only path to the loss is the fusion backward kernel);
  6. serving: `multi_scale_config()` at full width in bf16 with seeded
     random weights, 8 synthetic frames at batch 1 through
     `make_inference_fn`, checking finite outputs and that the path
     launched the fusion kernel 4 times and the clip kernel once per
     frame; p50 / p95 ms;
  7. training: `train()` on `multi_scale_config()` at full width in bf16,
     B=2, seed-varied synthetic frames through the augmenting loader, 1
     warm-up and 8 timed steps; finite losses and parameters, num_pos > 0,
     exactly 4 fusion forward, 4 fusion backward and 1 clip launches per
     step, a checkpoint restored into a fresh state; step p50 / p95 ms and
     peak memory;
  8. KNN selection: the KNN kernel against its plain version at the four
     scales of phase 3's frame and on a quarter-cell lattice with exact
     ties (valid and dist2 bit-equal, nbr bit-equal where valid and 0
     elsewhere); per case its launch shape (lanes per pixel, tile),
     kernel, plain and bound ms, and the replaced kernel's ms in the log;
     then the standalone KNN-selection path (`knn_select_dense` at the
     four scales) with its launches counted;
  9. the int8 micro-benchmark (`dcf_torch.tools.bench_int8_mma.run`):
     both kernels of `int8_mma.cu` (wgmma fed by TMA) against their
     plain version (int8 exact, bf16 within its float32 bound), times,
     TOP/s and TF/s, bounds, the `torch._int_mm` / `torch.matmul` times
     and the int8 / bf16 speedup;
 10. int8 serving: `multi_scale_config()` in bf16 with seeded random
     weights, calibrated on 8 varied frames, then 8 frames at B=1 through
     `make_inference_fn(quant_config(cfg), ...)`: finite outputs, 4 fusion
     and 1 clip launches per frame, the int32 products of the first BEV
     ConvNorm and of the largest image ConvNorm bit-equal between
     `torch._int_mm` and the float64 plain conv on the card; p50 / p95
     beside phase 6's bf16 p50, the head maps' relative L2 distance int8
     vs bf16, peak memory;
 11. a small int8 reference: `tiny_config` in float32 and int8 with the
     same weights and calibration on the card and on the CPU: every
     ConvNorm's int32 product on the card, fed the card's activation,
     equal to the CPU's plain conv of it; head maps within INT8_REL_L2 of
     the int8-vs-float32 distance;
 12. evaluation through the CLI (`dcf_torch.cli`): an 8-frame KITTI tree
     (`write_kitti_tree`, 375x1242 PNGs decoded back by `data/png.py`,
     ms per image), `build_gt_db`, `train --config full --steps 3` (the
     config's batch of 8; 4 / 4 / 1 launches per step), `evaluate
     --split val --num-frames 6 --batch-size 4 --num-points 0
     --results-dir ...` at full width (two batches, the second padded):
     an AP entry for every class x difficulty x metric, one result file
     per frame with 16 fields a line, 4 fusion forward and 1 clip
     launches per batch (the `eval` path), and every fusion forward and
     clip call of that run, recorded with its inputs, held to its plain
     version as phase 3 holds it (the forward bit-equal at B=4, the clip
     on the batch's 4 x 3 x 256 x 256 NMS pairs); `demo --config full
     --synthetic 1`; `run_eval` of `tiny_config` in float32 (TF32 off)
     on 4 frames on the card and on the CPU with the same weights: the
     same detections and AP dict; then seconds per frame of `run_eval`
     at full width on 16 synthetic frames at batch 8, split into
     inference and host evaluation, the latter with every detection of
     the random head (128 a frame) and with a trained model's count.

Then one JSON line describing every kernel (launches: the sum over the
paths, and per path), and last the line `{"ok": true, "device": {...}}`.
Any failure raises, and the script exits non-zero without a result; so
it does without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from dcf_torch.utils.timing import cuda_ms, graph_ms

T0 = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12            # outside the tensor cores

CLIP_TOL = 1e-4                   # x (1 + area): cosf/sinf may differ by an ulp
TINY_ATOL, TINY_RTOL = 2e-4, 2e-3  # x max|pred|; tests/test_oracle_e2e.py
TINY_GRAD_ATOL = 1e-3             # x max|want|; tests/test_torch_train.py
# int8 head maps, relative L2 distance between two runs (card and CPU)
# over the distance int8 vs float32: float32 noise flips a few roundings
# by one step and each flip moves every later layer, so one per-element
# bound does not hold end to end; independent quantization noise would
# sit near sqrt(2) (tests/test_torch_quant.py)
INT8_REL_L2 = 0.75
# phase 12: steps that fit tiny_config to its 4 frames before the card /
# CPU run_eval comparison (a CPU rehearsal: Pedestrian AP 0.125 after
# 50 steps, 0.25 after 100)
OVERFIT_STEPS = 100
# phase 12: detections a frame per gt box of the trained weights
# (runs_r5/gen_r5, ckpt_00008000) on the 16 val frames: 111 for 69 gt
# boxes in float32 on the CPU (tests/test_torch_ap.py prints them)
TRAINED_DETS_PER_GT = 111 / 69


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def selected_rows(sel, P: int) -> int:
    """The distinct (frame, point) rows of z1 that a stash selects."""
    import torch
    b = torch.arange(sel.shape[0], device=sel.device)[:, None, None, None]
    return int(torch.unique((b * P + sel.long())[sel >= 0]).numel())


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
    """The forward kernel at the four scales of one frame: bit-equal to
    its plain version, with and without the stash; per scale its launch
    shape (lanes per pixel, tile), kernel ms, ms with the stash, plain ms
    and bound."""
    import torch
    import torch.nn.functional as F
    from dcf_torch.ops import _cuda
    from dcf_torch.ops.fusion import (_forward, fused_fusion,
                                      fused_fusion_plain, fusion_launch_shape)
    rng = np.random.default_rng(0)
    tot = {"ms": 0.0, "stash_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "bytes": 0.0, "ops": 0.0, "err": 0.0}
    per_scale = []
    for s, args in fusion_inputs(cfg, example, device, rng):
        got = fused_fusion(*args)
        got_s, (sel, geo) = _forward(*args, stash=True)
        want, (psel, pgeo) = fused_fusion_plain(*args, stash=True)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise RuntimeError(f"fusion s{s}: kernel differs from plain, "
                               f"max|err| {err}")
        if not (torch.equal(got_s, want) and torch.equal(sel, psel)
                and torch.equal(geo, pgeo)):
            raise RuntimeError(f"fusion s{s}: the stash-writing kernel "
                               f"differs from plain")
        data, valid, z1, wgt, bg, _, _, k, r = args
        B, H, W = data.shape[:3]
        lanes, th, tw = fusion_launch_shape(B, H, W, _cuda.sm_count(device))
        blocks = B * -(-H // th) * -(-W // tw)
        ms = graph_ms(lambda: fused_fusion(*args))
        stash_ms = graph_ms(lambda: _forward(*args, stash=True))
        plain = cuda_ms(lambda: fused_fusion_plain(*args), 3)
        # what this data needs -- bytes: the valid mask read once, the
        # payload of its valid slots, the z1 rows of the selected points,
        # wgt and bg, the output written once; operations: 5 per valid
        # candidate in a window (2 sub, 2 mul, 1 add) and, per selected
        # pair, 4 for the geometry (2 sub, min, sqrt) plus 11 per hidden
        # channel (4 mul, 3 add, + bias, + z1, relu, + accumulate)
        hid = z1.shape[-1]
        n_bytes = (valid.numel() + 16 * int(valid.sum())
                   + 4 * hid * selected_rows(sel, z1.shape[1])
                   + 4 * (wgt.numel() + bg.numel() + got.numel()))
        per_cell = valid.sum(-1, dtype=torch.float32)[:, None]
        win = 2 * r + 1
        cands = F.conv2d(F.pad(per_cell, (r, r, r, r)),
                         torch.ones((1, 1, win, win), device=device)).sum()
        pairs = got[..., -1].sum()
        n_ops = 5 * cands.item() + pairs.item() * (4 + 11 * hid)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        log(f"fusion s{s}: {(H, W)} px, {lanes} lanes per pixel, tiles of "
            f"{th}x{tw} ({blocks} blocks), bit-equal with and without the "
            f"stash, kernel {ms:.4f} ms, with the stash {stash_ms:.4f} ms, "
            f"plain {plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{int(pairs.item())} pairs")
        per_scale.append({"stride": s, "pixels": B * H * W, "lanes": lanes,
                          "tile": [th, tw], "ms": ms, "stash_ms": stash_ms,
                          "bound_ms": b_ms})
        for key, v in (("ms", ms), ("stash_ms", stash_ms), ("plain_ms", plain),
                       ("bound_ms", b_ms), ("bytes", n_bytes),
                       ("ops", n_ops)):
            tot[key] += v
        tot["err"] = max(tot["err"], err)
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"])
    log(f"fusion: 4 scales {tot['ms']:.4f} ms, with the stash "
        f"{tot['stash_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "fusion_fwd", "route": "cuda",
            "source": "dcf_torch/csrc/fusion_fwd.cu",
            "replaces": "dcf/ops/pallas/fusion_kernel.py:765",
            "max_abs_err": tot["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "stash_ms": tot["stash_ms"],
            "per_scale": per_scale}


FUSION_BWD_EARLIER_MS = 0.1806   # the replaced kernel, four scales (H100)


def check_fusion_bwd(cfg, example, device):
    """The backward kernel against its plain version at the four scales of
    phase 3's frame: the kernel forward's stash (also checked equal to the
    plain forward's selections) and a seeded normal cotangent. Two
    launches give the same bits; d_z1 equals the plain version run on the
    CPU bit for bit (both sum each point's pairs in pair order), and all
    three outputs are within `fusion_bwd_tolerance` of the plain version
    on the card."""
    import torch
    from dcf_torch.ops import fusion as F
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    tot = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0,
           "ops": 0.0, "err": 0.0, "ratio": 0.0}
    per_scale = []
    for s, args in fusion_inputs(cfg, example, device, rng):
        data, valid, z1, wgt, bg, origin, cell, k, r = args
        out, stash = F._forward(*args, stash=True)
        want, (psel, pgeo) = F.fused_fusion_plain(*args, stash=True)
        torch.cuda.synchronize()
        if not (torch.equal(out, want) and torch.equal(stash[0], psel)
                and torch.equal(stash[1], pgeo)):
            raise RuntimeError(f"fusion s{s}: the kernel's stash or output "
                               f"differs from the plain forward's")
        B, H, W = data.shape[:3]
        hid = z1.shape[-1]
        dout = torch.randn((B, H, W, hid + 1), generator=gen, device=device)
        dacc = dout[..., :hid]
        got = F.fused_fusion_bwd(stash, z1, wgt, bg, dacc)
        again = F.fused_fusion_bwd(stash, z1, wgt, bg, dacc)
        ref = F.fused_fusion_bwd_plain(stash, z1, wgt, bg, dacc)
        tols = F.fusion_bwd_tolerance(stash, z1, wgt, bg, dacc)
        cpu = F.fused_fusion_bwd_plain(
            tuple(t.cpu() for t in stash), z1.cpu(), wgt.cpu(), bg.cpu(),
            dacc.cpu())
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"fusion bwd s{s}: two launches differ")
        if not torch.equal(got[0].cpu(), cpu[0]):
            raise RuntimeError(
                f"fusion bwd s{s}: d_z1 differs from the CPU plain version "
                f"at {int((got[0].cpu() != cpu[0]).sum())} elements")
        err, ratio = 0.0, 0.0
        for name, a, b, tol in zip(("d_z1", "d_wgt", "d_bg"), got, ref, tols):
            e = (a - b).abs()
            if not torch.isfinite(a).all() or bool((e > tol).any()):
                raise RuntimeError(
                    f"fusion bwd s{s}: {name} kernel vs plain max|err| "
                    f"{e.max().item()} beyond its bound at "
                    f"{int((e > tol).sum())} elements")
            err = max(err, e.max().item())
            ratio = max(ratio, (e / tol.clamp(min=1e-30)).max().item())
        sel, geo = stash
        outs = tuple(torch.empty_like(t) for t in (z1, wgt, bg))
        scratch, blocks = F.fusion_bwd_scratch(B, z1.shape[1], hid, device)
        # the entry point (fill, gather, combine) after the zero fill of
        # its counts, as the wrapper runs it; outputs and scratch
        # allocated once

        def launch():
            scratch[0].zero_()
            F._launch_bwd(stash, z1, wgt, bg, dacc, outs, scratch, blocks)
        ms = graph_ms(launch)
        wrapper = graph_ms(lambda: F.fused_fusion_bwd(stash, z1, wgt, bg,
                                                      dacc))
        plain = cuda_ms(lambda: F.fused_fusion_bwd_plain(stash, z1, wgt, bg,
                                                         dacc), 3)
        fwd_stash = graph_ms(lambda: F._forward(*args, stash=True))
        fwd = graph_ms(lambda: F._forward(*args, stash=False))
        # what this data needs -- bytes: sel read once, the features of
        # the selected pairs, the dacc rows (hid channels) of the pixels
        # with a selection, the z1 rows of the selected points, wgt and
        # bg, d_z1 / d_wgt / d_bg written once; operations: per selected
        # (pair, channel) 10 to rebuild pre and test it (4 mul, 3 add,
        # + bg, + z1, compare), per live one 10 more (the d_z1 add, 4 mul
        # and 5 adds into d_wgt / d_bg)
        n_sel = int((sel >= 0).sum())
        n_px = int((sel >= 0).any(-1).sum())
        rows, g, dpre = F._live_pairs(stash, z1, wgt, bg, dacc)
        n_live = int((dpre != 0).sum())
        n_bytes = (4 * sel.numel() + 16 * n_sel + 4 * hid * n_px
                   + 4 * hid * selected_rows(sel, z1.shape[1])
                   + 4 * z1.numel() + 8 * (wgt.numel() + bg.numel()))
        n_ops = 10.0 * n_sel * hid + 10.0 * n_live
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        log(f"fusion bwd s{s}: {(H, W)} px, {n_sel} pairs, {n_live} live "
            f"(pair, channel), two launches bit-identical, d_z1 bit-equal "
            f"to the CPU plain version, max|err| vs plain on the card "
            f"{err:.3g} ({ratio:.3g} of its bound), kernel {ms:.4f} ms "
            f"(wrapper with its allocations {wrapper:.4f} ms), plain "
            f"{plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}, {n_bytes} "
            f"bytes); forward {fwd:.4f} ms, with the stash {fwd_stash:.4f} ms")
        per_scale.append({"stride": s, "ms": ms, "bound_ms": b_ms})
        for key, v in (("ms", ms), ("wrapper_ms", wrapper),
                       ("plain_ms", plain), ("bytes", n_bytes),
                       ("ops", n_ops)):
            tot[key] += v
        tot["err"] = max(tot["err"], err)
        tot["ratio"] = max(tot["ratio"], ratio)
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"])
    log(f"fusion bwd: 4 scales {tot['ms']:.4f} ms (earlier kernel "
        f"{FUSION_BWD_EARLIER_MS} ms; per scale "
        f"{[round(p['ms'], 4) for p in per_scale]}; wrapper "
        f"{tot['wrapper_ms']:.4f} ms), plain "
        f"{tot['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}), max|err| "
        f"{tot['err']:.3g} ({tot['ratio']:.3g} of its bound)")
    return {"name": "fusion_bwd", "route": "cuda",
            "source": "dcf_torch/csrc/fusion_bwd.cu",
            "replaces": "dcf/ops/pallas/fusion_kernel.py:868",
            "max_abs_err": tot["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "per_scale": per_scale}


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


CLIP_EARLIER_MS = 0.0326         # the replaced kernel, 196,608 pairs (H100)


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
    n_diff = int((got != want).sum())
    ms = graph_ms(lambda: rotated_intersection_area_pairs(a, b))
    plain = cuda_ms(lambda: rotated_intersection_area_pairs_plain(a, b), 3)
    # bytes: 2 x [N, 5] f32 in, [N] f32 out; operations: clip_ops
    n_bytes = 2 * a.numel() * 4 + got.numel() * 4
    n_ops = clip_ops(a, b)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    log(f"clip: {n} pairs, {n_diff} differ from the plain version at "
        f"all, max|err| {err.max().item():.3g}, hard "
        f"{got[-len(CLIP_HARD):].tolist()}, "
        f"kernel {ms:.4f} ms (earlier kernel {CLIP_EARLIER_MS} ms), plain "
        f"{plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {n_ops / n:.1f} "
        f"operations per pair)")
    return {"name": "clip_pairs", "route": "cuda",
            "source": "dcf_torch/csrc/clip.cu",
            "replaces": "dcf/ops/pallas/clip_kernel.py:42",
            "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "pairs_differing": n_diff}


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


def _grad_leaves(model):
    from dcf_torch.params import grads_to_flax

    def walk(tree, prefix=""):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                yield from walk(tree[key], f"{prefix}/{key}")
            else:
                yield f"{prefix}/{key}", tree[key]
    return dict(walk(grads_to_flax(model)))


# parameters whose only path to the loss runs through the fusion backward
FUSION_GRAD_LEAVES = ("img_proj/kernel", "geo_kernel", "geo_bias",
                      "image_backbone/ConvNorm_0/Conv_0/kernel")


def check_tiny_train():
    """One tiny float32 train step on the card (kernels) and on the CPU
    (plain versions) from the same weights and batch: the loss, every
    metric and every gradient leaf agree, and the parameters reached only
    through the fusion backward get gradients on the card."""
    import dataclasses
    import torch
    from dcf_torch.config import tiny_config
    from dcf_torch.data.preprocess import frame_to_example, stack_examples
    from dcf_torch.data.synthetic import make_varied_frame
    from dcf_torch.eval.inference import batch_to_device
    from dcf_torch.models.anchors import anchor_pack
    from dcf_torch.ops.clip import rotated_intersection_area_pairs as clip
    from dcf_torch.ops.fusion import fused_fusion, fused_fusion_bwd
    from dcf_torch.params import init_params
    from dcf_torch.train.state import create_train_state
    from dcf_torch.train.step import make_train_step
    cfg = tiny_config(True)
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="float32"))
    batch = stack_examples([frame_to_example(make_varied_frame(seed=s), cfg)
                            for s in (0, 1)])
    out = {}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False     # a float32 reference
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            model = init_params(cfg, torch.Generator().manual_seed(0), dev)
            state = create_train_state(cfg, model)
            before = (fused_fusion.launches, fused_fusion_bwd.launches,
                      clip.launches)
            _, metrics = make_train_step(cfg, model, dev)(
                state, batch_to_device(batch, dev), anchor_pack(cfg, dev))
            torch.cuda.synchronize()
            launched = (fused_fusion.launches - before[0],
                        fused_fusion_bwd.launches - before[1],
                        clip.launches - before[2])
            out[dev] = ({k: float(v) for k, v in metrics.items()},
                        _grad_leaves(model), launched)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    (m_cpu, g_cpu, l_cpu), (m_gpu, g_gpu, l_gpu) = out["cpu"], out["cuda"]
    if l_cpu != (0, 0, 0) or l_gpu != (4, 4, 1):
        raise RuntimeError(f"tiny train: launches (fwd, bwd, clip) {l_gpu} "
                           f"on the card, {l_cpu} on the CPU; expected "
                           f"(4, 4, 1) and none")
    if m_gpu["num_pos"] != m_cpu["num_pos"] or m_cpu["num_pos"] <= 0:
        raise RuntimeError(f"tiny train: num_pos {m_gpu['num_pos']} on the "
                           f"card, {m_cpu['num_pos']} on the CPU")
    for k, want in m_cpu.items():
        if not abs(m_gpu[k] - want) <= TINY_ATOL * abs(want) \
                + TINY_RTOL * abs(want):
            raise RuntimeError(f"tiny train {k}: card {m_gpu[k]}, CPU {want}")
    worst = (0.0, "")
    for path, want in g_cpu.items():
        got = g_gpu[path]
        scale = max(np.abs(want).max(), 1e-30)
        excess = np.abs(got - want) - (TINY_GRAD_ATOL * scale
                                       + TINY_RTOL * np.abs(want))
        if (excess > 0).any() or not np.isfinite(got).all():
            raise RuntimeError(f"tiny train: gradient {path} card vs CPU "
                               f"max|err| {np.abs(got - want).max()}")
        worst = max(worst, (np.abs(got - want).max() / scale, path))
    for name in FUSION_GRAD_LEAVES:
        hits = [p for p in g_gpu if p.endswith(name)]
        if not hits or any(not np.abs(g_gpu[p]).max() > 0 for p in hits):
            raise RuntimeError(f"tiny train: no gradient for {name} on the "
                               f"card ({hits})")
    log(f"tiny train step (float32, B=2): card vs CPU loss "
        f"{m_gpu['loss']:.6f} / {m_cpu['loss']:.6f}, {len(g_cpu)} gradient "
        f"leaves agree (worst {worst[0]:.3g} x max|want| at {worst[1]}); "
        f"launches {l_gpu}; img_proj, geo_kernel, geo_bias and the image "
        f"stem have gradients on the card")


def train_full(device):
    """train() at full width: multi_scale_config in bf16, B=2, seed-varied
    synthetic frames through the augmenting Loader (gt-sampling from a
    database of a few of them), 1 warm-up step and 8 timed steps, one
    checkpoint written at the last step and restored into a fresh state.
    Returns the launches per step."""
    import dataclasses
    import shutil
    import torch
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data.augment import GTDatabase
    from dcf_torch.data.synthetic import SyntheticDataset
    from dcf_torch.ops.clip import rotated_intersection_area_pairs as clip
    from dcf_torch.ops.fusion import fused_fusion, fused_fusion_bwd
    from dcf_torch.params import init_params
    from dcf_torch.train import checkpoint as ckpt
    from dcf_torch.train.loop import train
    from dcf_torch.train.state import create_train_state
    steps = 9
    cfg = multi_scale_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2, log_every=1, checkpoint_every=steps))
    dataset = SyntheticDataset(8, varied=True)
    db = GTDatabase.build([dataset[i] for i in range(4)])
    workdir = os.path.join(HERE, "_train_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    marks, per_step = [], []

    def hook(state, step):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        per_step.append((fused_fusion.launches, fused_fusion_bwd.launches,
                         clip.launches))

    try:
        torch.cuda.reset_peak_memory_stats()
        fused_fusion.launches = fused_fusion_bwd.launches = 0
        clip.launches = 0
        state = train(cfg, dataset, workdir, device=device, gt_db=db,
                      num_steps=steps, eval_hook=hook, eval_every=1)
        peak = torch.cuda.max_memory_allocated()
        launches = {"fusion_fwd": fused_fusion.launches,
                    "fusion_bwd": fused_fusion_bwd.launches,
                    "clip_pairs": clip.launches}
        counts = [(0, 0, 0)] + per_step
        deltas = {tuple(b - a for a, b in zip(p, q))
                  for p, q in zip(counts, counts[1:])}
        if deltas != {(4, 4, 1)}:
            raise RuntimeError(f"training: launches per step (fwd, bwd, "
                               f"clip) {sorted(deltas)}, expected (4, 4, 1)")
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        if len(logged) != steps:
            raise RuntimeError(f"training: {len(logged)} metric lines")
        for m in logged:
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                    and m["num_pos"] > 0):
                raise RuntimeError(f"training: step {m['step']} metrics {m}")
        if not all(torch.isfinite(p).all() for p in state.model.parameters()):
            raise RuntimeError("training: non-finite parameters")
        latest = ckpt.latest_checkpoint(os.path.join(workdir, "checkpoints"))
        fresh = create_train_state(cfg, init_params(
            cfg, torch.Generator().manual_seed(1), device))
        fresh = ckpt.restore_checkpoint(latest, fresh)
        same = all(torch.equal(a, b) for a, b in zip(
            state.model.parameters(), fresh.model.parameters()))
        if fresh.step != steps or not same \
                or fresh.optimizer.count != steps:
            raise RuntimeError(f"training: checkpoint {latest} restored step "
                               f"{fresh.step}, parameters equal: {same}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    times = np.diff(marks) * 1e3                   # steps 2..9
    log(f"training: multi_scale_config, {cfg.backbone.dtype}, B=2, "
        f"{sum(p.numel() for p in state.model.parameters())} params, "
        f"{steps} steps: step p50 {np.percentile(times, 50):.3f} ms, p95 "
        f"{np.percentile(times, 95):.3f} ms over steps 2-{steps} "
        f"{[round(float(t), 3) for t in times]}, peak memory "
        f"{peak / 2 ** 30:.3f} GiB, losses "
        f"{[round(m['loss'], 4) for m in logged]}, num_pos "
        f"{[m['num_pos'] for m in logged]}, launches {launches} (4 / 4 / 1 "
        f"per step), checkpoint {os.path.basename(latest)} restored")
    return launches


def serve(device):
    import torch
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data.preprocess import frame_to_example, stack_examples
    from dcf_torch.data.synthetic import make_varied_frame
    from dcf_torch.eval.inference import make_inference_fn
    from dcf_torch.ops.clip import rotated_intersection_area_pairs
    from dcf_torch.ops.fusion import fused_fusion, fused_fusion_bwd
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

    fused_fusion.launches = fused_fusion_bwd.launches = 0
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
                "fusion_bwd": fused_fusion_bwd.launches,
                "clip_pairs": rotated_intersection_area_pairs.launches}
    n = len(times)
    expect = {"fusion_fwd": len(cfg.backbone.fusion_strides) * n,
              "fusion_bwd": 0, "clip_pairs": n}
    if launches != expect:
        raise RuntimeError(f"serving launches {launches} != {expect}")
    log(f"serving: {n} frames at B=1, p50 {np.percentile(times, 50):.3f} ms, "
        f"p95 {np.percentile(times, 95):.3f} ms, per frame "
        f"{[round(t, 3) for t in times]} ms, {n_valid} valid detections, "
        f"launches {launches}")
    return launches, float(np.percentile(times, 50))


def knn_bound(data, valid, k: int, r: int):
    """(bytes, operations) that one KNN selection of these bins needs:
    the valid mask read once, the payload of its valid slots, nbr / ok /
    dist2 written once; 5 f32 operations (2 sub, 2 mul, 1 add) per valid
    candidate of a window."""
    import torch
    import torch.nn.functional as F
    B, H, W, C, D = data.shape
    n_bytes = (valid.numel() + 4 * D * int(valid.sum())
               + B * H * W * k * (4 * D + 1 + 4))
    per_cell = valid.sum(-1, dtype=torch.float32)[:, None]
    win = 2 * r + 1
    cands = F.conv2d(F.pad(per_cell, (r, r, r, r)),
                     torch.ones((1, 1, win, win), device=data.device)).sum()
    return n_bytes, 5.0 * cands.item()


def knn_lattice_bins(device, H=352, W=400, P=200000, C=8):
    """Bins of P points on a quarter-cell lattice over an H x W grid of
    1 m cells (the s2 grid's size): many candidates at exactly equal
    distances from a pixel centre."""
    import torch
    from dcf_torch.ops.knn import bin_points_dense
    rng = np.random.default_rng(7)
    pts = np.zeros((1, P, 4), np.float32)
    pts[..., 0] = rng.integers(0, 4 * H, (1, P)) / 4 + 0.125
    pts[..., 1] = rng.integers(0, 4 * W, (1, P)) / 4 + 0.125
    pts[..., 2] = rng.uniform(-2, 2, (1, P))
    pts[..., 3] = np.arange(P)
    return bin_points_dense(torch.from_numpy(pts).to(device),
                            torch.ones((1, P), dtype=torch.bool,
                                       device=device),
                            (0.0, 0.0), 1.0, (H, W), C)


# the replaced thread-per-pixel KNN kernel, per case (H100, 700 W)
KNN_EARLIER_MS = {"s2": 0.0347, "s4": 0.0170, "s8": 0.0154, "s16": 0.0192,
                  "lattice": 0.0458}


def knn_cases(cfg, example, device):
    """(name, bins, origin, cell) of the KNN kernel's checks: the four
    scales of phase 3's frame, then the tie lattice."""
    from dcf_torch.ops.knn import DenseBins
    rng = np.random.default_rng(0)
    cases = [(f"s{s}", DenseBins(args[0], args[1]), args[5], args[6])
             for s, args in fusion_inputs(cfg, example, device, rng)]
    cases.append(("lattice", knn_lattice_bins(device), (0.0, 0.0), 1.0))
    return cases


def knn_agree(got, want):
    """(whether a KNN result equals the plain version's: ok and dist2 bit
    for bit, nbr where valid and 0 elsewhere; the max |error| of dist2 and
    nbr where both are valid)."""
    import torch
    v = want[1]
    equal = (torch.equal(got[1], v) and torch.equal(got[2], want[2])
             and torch.equal(got[0][v], want[0][v])
             and not bool(got[0][~v].any()))
    both = v & got[1]
    err = 0.0
    for g, w in ((got[2][both], want[2][both]),
                 (got[0][both], want[0][both])):
        if g.numel():
            err = max(err, (g - w).abs().max().item())
    return equal, err


def check_knn(cfg, example, device):
    """The KNN kernel against its plain version: the four scales of phase
    3's frame and a tie lattice; bit-equal valid / dist2, nbr where valid
    and 0 elsewhere; per case the launch shape, kernel, plain and bound
    ms (the replaced kernel's ms beside them in the log)."""
    from dcf_torch.ops import _cuda
    from dcf_torch.ops.knn import (knn_launch_shape, knn_select_dense,
                                   knn_select_plain)
    k, r = cfg.fusion.num_neighbors, cfg.fusion.search_radius_cells
    tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0, "err": 0.0}
    per_case = []
    for name, bins, origin, cell in knn_cases(cfg, example, device):
        got = knn_select_dense(bins, origin, cell, k, r)
        want = knn_select_plain(bins, origin, cell, k, r)
        equal, err = knn_agree(got, want)
        if not equal:
            raise RuntimeError(f"knn {name}: kernel and plain version "
                               f"disagree, max|err| {err}")
        v, d2 = want[1], want[2]
        ties = int(((d2[..., 1:] == d2[..., :-1]) & v[..., 1:]).sum())
        B, H, W, C, D = bins.data.shape
        lanes, th, tw = knn_launch_shape(B, H, W, C, D, k, r,
                                         _cuda.sm_count(device))
        ms = graph_ms(lambda: knn_select_dense(bins, origin, cell, k, r))
        plain = cuda_ms(lambda: knn_select_plain(bins, origin, cell, k, r),
                        3)
        n_bytes, n_ops = knn_bound(bins.data, bins.valid, k, r)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        log(f"knn {name}: {(H, W)} px, {lanes} lanes per pixel, tiles of "
            f"{th}x{tw} ({B * -(-H // th) * -(-W // tw)} blocks), "
            f"{int(v.sum())} neighbours, {ties} equal-distance neighbours, "
            f"bit-equal; kernel {ms:.4f} ms (replaced kernel "
            f"{KNN_EARLIER_MS[name]} ms), plain {plain:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {n_bytes} bytes)")
        per_case.append({"case": name, "pixels": B * H * W, "lanes": lanes,
                         "tile": [th, tw], "ms": ms, "bound_ms": b_ms})
        tot["err"] = max(tot["err"], err)
        if name == "lattice":
            if ties < 1000:
                raise RuntimeError(f"knn lattice: only {ties} ties")
            continue
        for key, val in (("ms", ms), ("plain_ms", plain),
                         ("bytes", n_bytes), ("ops", n_ops)):
            tot[key] += val
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"])
    log(f"knn: 4 scales {tot['ms']:.4f} ms (replaced kernel "
        f"{sum(KNN_EARLIER_MS[f's{s}'] for s in (2, 4, 8, 16)):.4f} ms), "
        f"plain {tot['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "knn_select", "route": "cuda",
            "source": "dcf_torch/csrc/knn.cu",
            "replaces": "dcf/ops/pallas/knn_kernel.py:61",
            "max_abs_err": tot["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "per_case": per_case}


def knn_path(cfg, example, device):
    """The standalone KNN-selection path: `knn_select_dense` over the
    binned points of one frame at every fusion scale."""
    import torch
    from dcf_torch.ops.knn import DenseBins, knn_select_dense
    rng = np.random.default_rng(0)
    inputs = fusion_inputs(cfg, example, device, rng)
    knn_select_dense.launches = 0
    n = 0
    for s, args in inputs:
        nbr, ok, d2 = knn_select_dense(DenseBins(args[0], args[1]), args[5],
                                       args[6], args[7], args[8])
        n += int(ok.sum())
    torch.cuda.synchronize()
    launches = {"knn_select": knn_select_dense.launches}
    if launches["knn_select"] != len(inputs) or n == 0:
        raise RuntimeError(f"knn path: launches {launches}, {n} neighbours")
    log(f"knn path: {len(inputs)} scales, {n} neighbours, launches "
        f"{launches}")
    return launches


def int8_bench(device):
    """Phase 9: the micro-benchmark's entry point, its launches counted."""
    from dcf_torch.ops import int8_mma
    from dcf_torch.tools import bench_int8_mma
    int8_mma.selection_mma_int8.launches = 0
    int8_mma.selection_mma_bf16.launches = 0
    r = bench_int8_mma.run(device)
    launches = {"selection_mma": int8_mma.selection_mma_int8.launches,
                "selection_mma_bf16": int8_mma.selection_mma_bf16.launches}
    if min(launches.values()) == 0:
        raise RuntimeError(f"int8 bench: launches {launches}")
    i8, bf = r["int8"], r["bf16"]
    log(f"int8 bench: {r['blocks']} programs, int8 {i8['ms']:.4f} ms "
        f"({i8['rate']:.1f} TOP/s, bound {i8['bound_ms']:.4f} ms, "
        f"_int_mm {i8['library_ms']:.4f} ms, plain {i8['plain_ms']:.3f} ms), "
        f"bf16 {bf['ms']:.4f} ms ({bf['rate']:.1f} TF/s, bound "
        f"{bf['bound_ms']:.4f} ms, matmul {bf['library_ms']:.4f} ms, plain "
        f"{bf['plain_ms']:.3f} ms, max|err| {bf['max_abs_err']:.3g}), "
        f"speedup {r['speedup']:.3f}x, launches {launches}")
    entry = {"name": "selection_mma", "route": "cuda",
             "source": "dcf_torch/csrc/int8_mma.cu",
             "replaces": "scripts/bench_int8_fusion_matmul.py:33",
             "max_abs_err": i8["max_abs_err"], "ms": i8["ms"],
             "plain_ms": i8["plain_ms"], "bound_ms": i8["bound_ms"],
             "bound_by": "operations", "library_ms": i8["library_ms"],
             "blocks": r["blocks"], "speedup_over_bf16": r["speedup"],
             "bf16": {"launches": launches["selection_mma_bf16"],
                      "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
                      "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
                      "bound_by": "operations",
                      "library_ms": bf["library_ms"]}}
    return entry, launches


def _head_rel_l2(got, want):
    import torch
    return {k: (torch.linalg.vector_norm((got[k] - want[k]).double())
                / torch.linalg.vector_norm(want[k].double())).item()
            for k in want}


def _capture_inputs(model, names):
    """Forward pre-hooks recording the input of each named module."""
    inputs, hooks = {}, []
    mods = dict(model.named_modules())
    for name in names:
        hooks.append(mods[name].register_forward_pre_hook(
            lambda mod, args, name=name: inputs.__setitem__(name, args[0])))
    return inputs, hooks


def serve_int8(device, bf16_p50: float):
    """Phase 10: int8 serving of the flagship at full width."""
    import torch
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data.preprocess import frame_to_example, stack_examples
    from dcf_torch.data.synthetic import make_varied_frame
    from dcf_torch.eval.inference import batch_to_device, make_inference_fn
    from dcf_torch.models.layers import ConvNorm
    from dcf_torch.ops import int8
    from dcf_torch.ops.clip import rotated_intersection_area_pairs as clip
    from dcf_torch.ops.fusion import fused_fusion, fused_fusion_bwd
    from dcf_torch.ops.knn import knn_select_dense
    from dcf_torch.params import from_flax, init_params, to_flax
    from dcf_torch.quant import calibrate, quant_config
    cfg = multi_scale_config()
    cfg8 = quant_config(cfg)

    def frames(seeds):
        return [stack_examples([frame_to_example(make_varied_frame(seed=s),
                                                 cfg)]) for s in seeds]
    model = init_params(cfg, torch.Generator().manual_seed(0), device=device)
    t = time.time()
    quant = calibrate(cfg, model, frames(range(100, 108)))
    torch.cuda.synchronize()
    calib_s = time.time() - t
    model8 = from_flax({**to_flax(model), **quant}, cfg8, device=device)
    infer8 = make_inference_fn(cfg8, model8, device=device)
    batches = frames(range(9))
    norms = [n for n, m in model8.named_modules() if isinstance(m, ConvNorm)]
    infer8(batches[-1])                             # warm-up frame
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    fused_fusion.launches = fused_fusion_bwd.launches = 0
    clip.launches = knn_select_dense.launches = int8.int8_conv2d.launches = 0
    times, n_valid = [], 0
    for batch in batches[:-1]:
        t = time.perf_counter()
        dets = infer8(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if not (torch.isfinite(dets["boxes"]).all()
                and torch.isfinite(dets["scores"]).all()):
            raise RuntimeError("int8 serving: non-finite detections")
        n_valid += int(dets["valid"].sum())
    peak = torch.cuda.max_memory_allocated()
    launches = {"fusion_fwd": fused_fusion.launches,
                "fusion_bwd": fused_fusion_bwd.launches,
                "clip_pairs": clip.launches,
                "knn_select": knn_select_dense.launches}
    n = len(times)
    expect = {"fusion_fwd": len(cfg.backbone.fusion_strides) * n,
              "fusion_bwd": 0, "clip_pairs": n, "knn_select": 0}
    n_convs = int8.int8_conv2d.launches
    if launches != expect or n_convs != len(norms) * n:
        raise RuntimeError(f"int8 serving launches {launches}, int8 convs "
                           f"{n_convs}; expected {expect} and "
                           f"{len(norms) * n}")

    # one frame: the head maps against bf16, and the int32 products of the
    # first BEV ConvNorm and the largest image ConvNorm, _int_mm against
    # the float64 plain conv
    first = "bev_stage0_block0.ConvNorm_0"
    image = [nm for nm in norms if nm.startswith("image_backbone.")]
    inputs, hooks = _capture_inputs(model8, [first] + image)
    b = batch_to_device(batches[0], device)
    with torch.no_grad():
        maps8 = model8(b)
        maps = model(b)
    for h in hooks:
        h.remove()
    mods = dict(model8.named_modules())

    def macs(nm):
        x, m = inputs[nm], mods[nm]
        ho, wo = -(-x.shape[1] // m.stride), -(-x.shape[2] // m.stride)
        return x.shape[0] * ho * wo * m.Conv_0.weight[0].numel() \
            * m.Conv_0.out_channels
    largest = max(image, key=macs)
    for nm in (first, largest):
        xq, wq, _, _ = mods[nm].quantized(inputs[nm])
        got = int8.int8_conv2d_mm(xq, wq, mods[nm].stride)
        want = int8.int8_conv2d_plain(xq, wq, mods[nm].stride)
        if not torch.equal(got, want):
            raise RuntimeError(f"int8 serving: {nm} _int_mm and float64 "
                               f"conv differ")
        log(f"int8 serving: {nm} int32 product {tuple(got.shape)} (K = "
            f"{wq[0].numel()}) bit-equal, _int_mm vs float64 conv")
    rel = _head_rel_l2(maps8, maps)
    log(f"int8 serving: multi_scale_config int8 (bf16 elsewhere), "
        f"calibrated on 8 frames in {calib_s:.2f} s, {n} frames at B=1: "
        f"p50 {np.percentile(times, 50):.3f} ms, p95 "
        f"{np.percentile(times, 95):.3f} ms (bf16 p50 {bf16_p50:.3f} ms "
        f"above), per frame {[round(t, 3) for t in times]} ms, {n_valid} "
        f"valid detections, head maps int8 vs bf16 relative L2 "
        f"{ {k: round(v, 5) for k, v in rel.items()} }, peak memory "
        f"{peak / 2 ** 30:.3f} GiB, launches {launches}, {n_convs} int8 "
        f"convs ({len(norms)} ConvNorms per frame)")
    return launches


def check_tiny_int8():
    """Phase 11: tiny_config in float32 and int8, same weights and
    calibration, card against CPU."""
    import dataclasses
    import torch
    from dcf_torch.config import tiny_config
    from dcf_torch.data.preprocess import frame_to_example, stack_examples
    from dcf_torch.data.synthetic import make_frame, make_varied_frame
    from dcf_torch.eval.inference import batch_to_device, make_inference_fn
    from dcf_torch.models.layers import ConvNorm
    from dcf_torch.ops import int8
    from dcf_torch.params import from_flax, init_params, to_flax
    from dcf_torch.quant import calibrate, quant_config
    cfg = tiny_config(True)
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="float32"))
    cfg8 = quant_config(cfg)
    calib = [stack_examples([frame_to_example(make_varied_frame(seed=s),
                                              cfg)]) for s in (1, 2)]
    batch = stack_examples([frame_to_example(make_frame(seed=0), cfg)])
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = {**to_flax(cpu), **calibrate(cfg, cpu, calib)}
    cpu8 = from_flax(tree, cfg8, device="cpu")
    gpu8 = from_flax(tree, cfg8, device="cuda")
    norms = [n for n, m in gpu8.named_modules() if isinstance(m, ConvNorm)]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False     # a float32 reference
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        inputs, hooks = _capture_inputs(gpu8, norms)
        with torch.no_grad():
            want = cpu8(batch_to_device(batch, "cpu"))
            f32 = cpu(batch_to_device(batch, "cpu"))
            got = gpu8(batch_to_device(batch, "cuda"))
        for h in hooks:
            h.remove()
        dets = make_inference_fn(cfg8, gpu8, device="cuda")(batch)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    mods = dict(gpu8.named_modules())
    for nm in norms:            # each layer fed the card's own activation
        xq, wq, _, _ = mods[nm].quantized(inputs[nm])
        y = int8.int8_conv2d(xq, wq, mods[nm].stride)
        if not torch.equal(y.cpu(), int8.int8_conv2d_plain(
                xq.cpu(), wq.cpu(), mods[nm].stride)):
            raise RuntimeError(f"tiny int8: {nm} card product differs")
    got = {k: v.cpu() for k, v in got.items()}
    dist, noise = _head_rel_l2(got, want), _head_rel_l2(want, f32)
    scale = {k: max(want[k].abs().max().item(), 1e-3) for k in want}
    within = {k: float(torch.isclose(got[k].double(), want[k].double(),
                                     atol=TINY_ATOL * scale[k],
                                     rtol=TINY_RTOL).double().mean())
              for k in want}
    for k in want:
        if not (torch.isfinite(got[k]).all() and noise[k] > 1e-3
                and dist[k] < INT8_REL_L2 * noise[k]):
            raise RuntimeError(f"tiny int8 {k}: card vs CPU relative L2 "
                               f"{dist[k]}, int8 vs float32 {noise[k]}")
    if not torch.isfinite(dets["boxes"]).all():
        raise RuntimeError("tiny int8: non-finite detections")
    log(f"tiny int8 reference (float32 elsewhere): {len(norms)} ConvNorm "
        f"int32 products on the card equal the CPU's; head maps card vs "
        f"CPU relative L2 { {k: round(v, 5) for k, v in dist.items()} } "
        f"against int8 vs float32 "
        f"{ {k: round(v, 5) for k, v in noise.items()} } (limit "
        f"{INT8_REL_L2} x); share within phase 4's float32 tolerance "
        f"{ {k: round(v, 4) for k, v in within.items()} }")


@contextlib.contextmanager
def _recorded(module, name, calls):
    """While inside, every call of `module.<name>` is appended to `calls`
    as (args, output)."""
    orig = getattr(module, name)

    def record(*args):
        out = orig(*args)
        calls.append((args, out))
        return out
    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, orig)


def check_eval_kernels(fusion_calls, clip_calls, device):
    """The fusion forward and the clip on the inputs that the `eval` path
    gave them (recorded in `cli.evaluate`: B=4 frames a batch, z1 from
    the trained model, the NMS pairs of the batch): every forward call
    bit-equal to its plain version, as phase 3 holds it, with its launch
    shape; the clip within CLIP_TOL, as phase 3 holds it."""
    import torch
    from dcf_torch.ops import _cuda
    from dcf_torch.ops.clip import rotated_intersection_area_pairs_plain
    from dcf_torch.ops.fusion import fused_fusion_plain, fusion_launch_shape
    shapes = []
    for args, got in fusion_calls:
        want = fused_fusion_plain(*args)
        B, H, W = args[0].shape[:3]
        if not torch.equal(got, want):
            raise RuntimeError(
                f"eval: fusion forward at B={B}, {(H, W)} differs from "
                f"plain, max|err| {(got - want).abs().max().item()}")
        lanes, th, tw = fusion_launch_shape(B, H, W, _cuda.sm_count(device))
        shapes.append(f"B={B} {H}x{W}: {lanes} lanes, {th}x{tw}")
    n_pairs = n_diff = 0
    err_max = 0.0
    for (a, b), got in clip_calls:
        want = rotated_intersection_area_pairs_plain(a, b)
        err = (got - want).abs()
        if (err > CLIP_TOL * (1 + want.abs())).any() or \
                not torch.isfinite(got).all():
            raise RuntimeError(f"eval: clip on {a.shape[0]} NMS pairs "
                               f"disagrees, max|err| {err.max().item()}")
        n_pairs += a.shape[0]
        n_diff += int((got != want).sum())
        err_max = max(err_max, err.max().item())
    log(f"eval: the `eval` path's own inputs: {len(fusion_calls)} fusion "
        f"forward calls bit-equal to plain ({'; '.join(shapes)}); "
        f"{len(clip_calls)} clip calls, {n_pairs} NMS pairs, {n_diff} "
        f"differ from plain at all, max|err| {err_max:.3g}")


def eval_cli():
    """Phase 12: the evaluation workflow through the CLI's `main()`s on
    the card, in a KITTI tree written by the port. Returns the launches of
    the `evaluate` run (the `eval` path)."""
    import io
    import shutil
    import torch
    from dcf_torch.cli import build_gt_db, demo, evaluate, train
    from dcf_torch.data.png import read_png
    from dcf_torch.data.synthetic import make_frame, write_kitti_tree
    from dcf_torch.models import fusion as fusion_mod, head as head_mod
    from dcf_torch.ops.clip import rotated_intersection_area_pairs as clip
    from dcf_torch.ops.fusion import fused_fusion, fused_fusion_bwd
    from dcf_torch.train import checkpoint as ckpt

    def counts():
        return {"fusion_fwd": fused_fusion.launches,
                "fusion_bwd": fused_fusion_bwd.launches,
                "clip_pairs": clip.launches}

    def zero():
        fused_fusion.launches = fused_fusion_bwd.launches = 0
        clip.launches = 0

    work = os.path.join(HERE, "_eval_smoke")
    shutil.rmtree(work, ignore_errors=True)
    root, db = os.path.join(work, "kitti"), os.path.join(work, "gt_db.pkl")
    workdir, results = os.path.join(work, "run"), os.path.join(work, "res")
    dev = ["--device", "cuda"]
    try:
        # 8 frames: one batch of the full config's 8 (the loader drops a
        # short batch); the evaluation serves the first 6
        ids = write_kitti_tree(root, num_frames=8, split="val")
        decode_ms = []
        for fid in ids:
            t = time.perf_counter()
            img = read_png(os.path.join(root, "training", "image_2",
                                        fid + ".png"))
            decode_ms.append((time.perf_counter() - t) * 1e3)
            if not np.array_equal(img, make_frame(fid, seed=int(fid)).image):
                raise RuntimeError(f"eval: {fid}.png decodes to other pixels")
        log(f"eval: KITTI tree of {len(ids)} frames, {img.shape} PNGs "
            f"decoded by data/png.py equal to the frames, decode ms "
            f"{[round(m, 3) for m in decode_ms]} (p50 "
            f"{np.percentile(decode_ms, 50):.3f})")
        build_gt_db.main(["--data-root", root, "--split", "val", "--out", db,
                          "--min-points", "1"] + dev)
        zero()
        t = time.perf_counter()
        train.main(["--config", "full", "--data-root", root, "--split",
                    "val", "--workdir", workdir, "--steps", "3",
                    "--gt-db", db] + dev)
        train_s = time.perf_counter() - t
        trained = counts()
        if trained != {"fusion_fwd": 12, "fusion_bwd": 12, "clip_pairs": 3}:
            raise RuntimeError(f"eval: cli.train launches {trained}, "
                               f"expected 4 / 4 / 1 per step over 3 steps")
        latest = ckpt.latest_checkpoint(os.path.join(workdir, "checkpoints"))
        if not latest.endswith("ckpt_00000003.pt"):
            raise RuntimeError(f"eval: cli.train left {latest}")

        n_eval = 6
        zero()
        out = io.StringIO()
        fusion_calls, clip_calls = [], []
        t = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                _recorded(fusion_mod, "fused_fusion", fusion_calls), \
                _recorded(head_mod, "rotated_intersection_area_pairs",
                          clip_calls):
            evaluate.main(["--workdir", workdir, "--data-root", root,
                           "--split", "val", "--num-frames", str(n_eval),
                           "--batch-size", "4", "--num-points", "0",
                           "--results-dir", results] + dev)
        eval_s = time.perf_counter() - t
        launches = counts()
        batches = -(-n_eval // 4)
        expect = {"fusion_fwd": 4 * batches, "fusion_bwd": 0,
                  "clip_pairs": batches}
        if launches != expect:
            raise RuntimeError(f"eval: launches {launches} != {expect}")
        check_eval_kernels(fusion_calls, clip_calls, torch.device("cuda"))
        del fusion_calls, clip_calls
        text = out.getvalue()
        aps = json.loads(text[text.index("{"):])
        want = {f"{c}_{m}_{d}" for c in ("Car", "Pedestrian", "Cyclist")
                for m in ("3d", "bev") for d in ("easy", "moderate", "hard")}
        if set(aps) != want or not all(0.0 <= v <= 1.0 for v in aps.values()):
            raise RuntimeError(f"eval: AP entries {sorted(aps)}")
        files = sorted(os.listdir(results))
        if files != [f"{fid}.txt" for fid in ids[:n_eval]]:
            raise RuntimeError(f"eval: result files {files}")
        n_lines = 0
        for name in files:
            with open(os.path.join(results, name)) as f:
                for line in f:
                    n_lines += 1
                    if len(line.split()) != 16:
                        raise RuntimeError(f"eval: {name}: {line!r}")
        log(f"eval: cli.train full width, the config's B=8, 3 steps in "
            f"{train_s:.3f} s, launches {trained}; cli.evaluate {n_eval} "
            f"frames in {batches} batches of 4 (the last padded) in "
            f"{eval_s:.3f} s, launches {launches}, {len(files)} result "
            f"files with {n_lines} detections, AP (exact) "
            f"{ {k: round(v, 4) for k, v in aps.items()} }")

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            demo.main(["--config", "full", "--synthetic", "1"] + dev)
        head = out.getvalue().splitlines()[0]
        if not head.startswith("frame 000000:"):
            raise RuntimeError(f"eval: cli.demo printed {head!r}")
        log(f"eval: cli.demo --config full: {head}")
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def check_eval_reference():
    """`run_eval` of tiny_config in float32 on 4 seed-varied frames in
    batches of 2, the same weights on the card (kernels) and on the CPU
    (plain versions), TF32 off: the same detections (names exact, boxes
    within phase 4's 1e-3, scores within 1e-4) and the same AP dict
    (within 1e-9). The weights are first fitted to those frames on the
    card (OVERFIT_STEPS steps on one batch of the 4), so that some AP
    entries are above 0 and the comparison sees matches."""
    import dataclasses
    import torch
    from dcf_torch.config import tiny_config
    from dcf_torch.data.preprocess import frame_to_example, stack_examples
    from dcf_torch.data.synthetic import SyntheticDataset
    from dcf_torch.eval.evaluate import detect
    from dcf_torch.eval.inference import batch_to_device, make_inference_fn
    from dcf_torch.eval.kitti_eval import evaluate_annotations
    from dcf_torch.models.anchors import anchor_pack
    from dcf_torch.params import init_params
    from dcf_torch.train.state import create_train_state
    from dcf_torch.train.step import make_train_step
    cfg = tiny_config(True)
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="float32"),
        train=dataclasses.replace(cfg.train, learning_rate=1e-3,
                                  warmup_steps=50))
    data = [SyntheticDataset(4, varied=True)[i] for i in range(4)]
    fitted = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    state = create_train_state(cfg, fitted)
    step = make_train_step(cfg, fitted, "cuda")
    batch = batch_to_device(stack_examples(
        [frame_to_example(f, cfg) for f in data]), "cuda")
    pack = anchor_pack(cfg, "cuda")
    t = time.perf_counter()
    for _ in range(OVERFIT_STEPS):
        state, metrics = step(state, batch, pack)
    loss = float(metrics["loss"])
    fit_s = time.perf_counter() - t
    runs = {}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False     # a float32 reference
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            model = init_params(cfg, torch.Generator().manual_seed(1),
                                device=dev)
            model.load_state_dict(fitted.state_dict())
            infer = make_inference_fn(cfg, model, device=dev)
            gts, dets = detect(cfg, infer, data, batch_size=2)
            runs[dev] = (dets, {p: evaluate_annotations(gts, dets,
                                                        num_points=p)
                                for p in (0, 40)})
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    (want, ap_want), (got, ap_got) = runs["cpu"], runs["cuda"]
    n = 0
    for g, w in zip(got, want):
        n += len(w)
        if g.names != w.names or not (
                np.allclose(g.boxes7, w.boxes7, rtol=0, atol=1e-3)
                and np.allclose(g.scores, w.scores, rtol=0, atol=1e-4)):
            raise RuntimeError("eval reference: card and CPU detections "
                               "differ")
    for p in ap_want:
        if ap_got[p].keys() != ap_want[p].keys() or any(
                abs(ap_got[p][k] - v) > 1e-9 for k, v in ap_want[p].items()):
            raise RuntimeError(f"eval reference: AP (num_points {p}) card "
                               f"{ap_got[p]} against CPU {ap_want[p]}")
    above = {k: round(v, 4) for k, v in ap_want[0].items() if v > 0}
    log(f"eval reference: tiny float32 fitted on the card for "
        f"{OVERFIT_STEPS} steps ({fit_s:.1f} s, loss {loss:.4f}); run_eval "
        f"of {len(want)} frames: {n} detections equal card vs CPU, AP "
        f"dicts equal at num_points 0 and 40; entries above 0 (exact) "
        f"{above}")


def time_eval(device):
    """Seconds per frame of `run_eval`'s two halves at full width:
    `detect` (host preprocessing, inference in batches of 8, one sync per
    batch; the synchronized inference calls timed apart; the frames are
    made before, as a reader would have them) and the host
    evaluation (`evaluate_annotations`: IoU and matching, R40), on 16
    seed-varied frames, seeded random weights in bf16. The random head
    passes every one of the 128 detections a frame (the heaviest input,
    an upper bound); the evaluation is timed again on each frame's
    highest-scoring TRAINED_DETS_PER_GT x its gt boxes, the traffic of a
    trained model."""
    import torch
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data.synthetic import SyntheticDataset
    from dcf_torch.eval.evaluate import detect
    from dcf_torch.eval.inference import make_inference_fn
    from dcf_torch.eval.kitti_eval import Annotation, evaluate_annotations
    from dcf_torch.params import init_params
    cfg = multi_scale_config()
    model = init_params(cfg, torch.Generator().manual_seed(0), device=device)
    infer = make_inference_fn(cfg, model, device=device)
    data = [SyntheticDataset(16, varied=True)[i] for i in range(16)]
    detect(cfg, infer, data[:8], batch_size=8)
    infer_s = []

    def timed(batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = infer(batch)
        torch.cuda.synchronize()
        infer_s.append(time.perf_counter() - t)
        return out

    t = time.perf_counter()
    gts, dets = detect(cfg, timed, data, batch_size=8)
    detect_s = time.perf_counter() - t
    trained = []
    for g, d in zip(gts, dets):
        keep = np.argsort(-d.scores, kind="stable")[
            :round(TRAINED_DETS_PER_GT * len(g))]
        trained.append(Annotation(
            names=[d.names[i] for i in keep], boxes7=d.boxes7[keep],
            bbox2d=d.bbox2d[keep], truncated=d.truncated[keep],
            occluded=d.occluded[keep], alpha=d.alpha[keep],
            scores=d.scores[keep]))
    n, host_s, n_det = len(data), {}, {}
    for key, ds in (("all", dets), ("trained", trained)):
        t = time.perf_counter()
        aps = evaluate_annotations(gts, ds, num_points=40)
        host_s[key] = time.perf_counter() - t
        n_det[key] = sum(len(d) for d in ds)
        if len(aps) != 18 or n_det[key] == 0:
            raise RuntimeError(f"eval timing: {len(aps)} AP entries, "
                               f"{n_det[key]} detections")
    log(f"eval timing: run_eval halves at full width, bf16, {n} frames at "
        f"batch 8, {sum(len(g) for g in gts)} gt boxes: detect "
        f"{detect_s / n:.4f} s a frame (inference {sum(infer_s) / n:.4f} s "
        f"a frame, synchronized, {len(infer_s)} batches; host "
        f"preprocessing and conversion the rest); host evaluation (IoU and "
        f"matching, 3d + bev, R40) {host_s['all'] / n:.4f} s a frame with "
        f"every detection ({n_det['all'] / n:.1f} a frame, the upper "
        f"bound), {host_s['trained'] / n:.4f} s a frame with a trained "
        f"model's count ({n_det['trained'] / n:.1f} a frame)")


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
    kernels = [check_fusion(cfg, example, device),
               check_fusion_bwd(cfg, example, device), check_clip(device)]
    check_tiny_reference()
    check_tiny_train()
    serving, bf16_p50 = serve(device)
    paths = {"serving": serving, "training": train_full(device)}
    kernels.append(check_knn(cfg, example, device))
    paths["knn_select"] = knn_path(cfg, example, device)
    mma, paths["int8_bench"] = int8_bench(device)
    kernels.append(mma)
    paths["int8_serving"] = serve_int8(device, bf16_p50)
    check_tiny_int8()
    paths["eval"] = eval_cli()
    check_eval_reference()
    time_eval(device)
    for k in kernels:
        by_path = {p: n.get(k["name"], 0) for p, n in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
