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
     --synthetic 1 --viz PNG` (the PNG decoded back by `data/png.py`: its
     size, and red on the top detection's outline); `train --config tiny
     --debug --steps 1` (anomaly detection and finite checks on the
     card); `run_eval` of `tiny_config` in float32 (TF32 off)
     on 4 frames on the card and on the CPU with the same weights: the
     same detections and AP dict; then seconds per frame of `run_eval`
     at full width on 16 synthetic frames at batch 8, split into
     inference and host evaluation, the latter with every detection of
     the random head (128 a frame) and with a trained model's count;
 13. the compiled host core (`dcf_torch.native`, `kitti_io.cpp` built by
     g++ into `dcf_torch/_build/` beside phase 2's nvcc processes, since
     every phase's frames go through it; the compiler's version line, the
     flags, the seconds and the stamped library logged): on a 4-frame
     375x1242 KITTI tree (`_host_smoke/`, removed after) every entry point
     held to its plain numpy version, bit-equal (the rotated IoUs within
     1e-9): the row unfilter and the whole decode on each frame's PNG and
     on frame 0's image written with every row None, Sub, Up, Average and
     Paeth; the crop on each frame and on a 120,000-point sweep; the
     resize with the letterbox and s2d(4), the fine-grid sort, the
     perspective divide and the fusion ranks of each frame at the
     config's size; the IoUs and the matching statistics (41 thresholds,
     every class, with and without alphas) on phase 12's detections at
     128 a frame. Then the compiled and plain host ms of each, beside the
     card's name and power limit, `frame_to_example` ms a frame, phase
     12's `run_eval` readings (host preprocessing, host evaluation at 128
     detections and at the trained count), the loader's ms per batch of 2
     (`tools/profile_training.py`'s reading), and the 4 frames served
     through the compiled host path at full width in bf16: finite, 4
     fusion and 1 clip launches a frame (the `host_core` path);
 14. data parallel: two ranks of `tiny_config` in float32 (TF32 off) on
     the one card through gloo, in processes of their own
     (`chip_smoke.py --data-parallel-rank ...`; NCCL needs a card per
     rank and is not exercised), 3 steps on two frames whose num_pos
     differ (checked on the card), one a rank: the ranks end bit-equal;
     their logged loss and grad_norm, parameters and EMA against a
     single-process B=2 run on the card within DP_METRIC_RTOL / DP_ATOL
     (with DP_NEAR_SHARE); rank 0 alone wrote the checkpoint and
     metrics; each rank's 4 / 4 / 1 launches a step (the `data_parallel`
     path);
 15. the train-and-evaluate workflow (`dcf_torch.tools.generalization`)
     at full width in bf16: 20 steps on 8 train frames with EMA and
     gt-sampling, probe evaluations every 10 steps on 2 frames, 4 val
     frames, the int8 evaluation, in a workdir removed after: both JSON
     files with the JAX script's keys and APs in [0, 1], and the
     launches of every training step, served batch and calibration
     batch (the `generalization` path);
 16. PointPillars: pillarization and the PFN fused with its scatter
     against their plain versions on the card at the KITTI car network's
     shapes (P = 12,000 pillars of N = 100 points, C = 64, a bf16
     432 x 496 canvas), bit-equal, on frames of 4,000 / 11,000 / 18,000
     ground points (the serving mix's range; the pillar cap binds on the
     last), a crop's full 24,576 points spread over the ROI (the pillar
     cap binds hard) and heaped into 200 pillars (the slot cap binds);
     kernel ms from a CUDA graph, plain ms, and the bound of each from
     the bytes the benchmark's roofline readers count
     (`perfbench/families/pointpillars.py`); then 8 frames of 4,000 to
     18,000 ground points served through `make_inference_fn` with seeded
     weights: 1 pillarize, 1 PFN and 1 clip launch a frame (the
     `pointpillars` path), p50 / p95 ms, and, served again with the
     program's tracer on, host syncs a frame no more than NMS rounds + 1
     (pillarization adds none) and the pillar counters;
 17. the graphed serving forward (`dcf_torch.utils.graphs`): 8
     `multi_scale_config()` frames in bf16 with seeded weights served
     through `make_inference_fn` with the tracer on, first with the
     forward held eager, then as served (the first frame eager, the
     second captured, the rest replayed): the head maps returned bit-equal
     to the eager pass's frame by frame, read after every frame was
     served (so no replay overwrote a map handed out), the detections
     equal, `graph.captures` 1 and `graph.forwards` 6, the fusion
     counters equal, 4 fusion and 1 clip launches and one call of the
     image backbone and of each fusion module a frame; `infer.forward`
     host ms a frame eager and replayed (p50), and peak memory.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel
from dcf_torch.utils.flops import H100_HBM_BYTES_PER_S, H100_PEAK_F32_FLOPS
from dcf_torch.utils.timing import cuda_ms, graph_ms

T0 = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))

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
# phase 14: two ranks against one process at the same global batch, in
# float32 with TF32 off (tests/test_torch_parallel.py holds the CPU run
# to the same bounds): the logged loss and grad_norm within DP_METRIC_RTOL
# (the card sums in other orders than the CPU: cuDNN picks its algorithm
# by batch size, and the gathers' backward adds with atomics); the
# parameters and EMA within DP_ATOL (tests/test_multihost.py's), with at
# most DP_NEAR_SHARE of their elements more than DP_NEAR apart (AdamW
# turns noise on gradients near its eps into steps of the learning rate)
DP_STEPS = 3
DP_METRIC_RTOL = 1e-4
DP_ATOL, DP_NEAR, DP_NEAR_SHARE = 3e-4, 1e-6, 1e-3


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def selected_rows(sel, P: int) -> int:
    """The distinct (frame, point) rows of z1 that a stash selects."""
    import torch
    b = torch.arange(sel.shape[0], device=sel.device)[:, None, None, None]
    return int(torch.unique((b * P + sel.long())[sel >= 0]).numel())


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_PEAK_F32_FLOPS * 1e3
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
        # a graphed forward rewrites its tensors in place on its next call
        calls.append((tuple(a.clone() if hasattr(a, "clone") else a
                            for a in args), out))
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
        png = os.path.join(work, "demo.png")
        drawn = []
        draw_bev = demo.draw_bev

        def record(*args, **kw):
            drawn.append(kw)
            return draw_bev(*args, **kw)
        demo.draw_bev = record
        try:
            with contextlib.redirect_stdout(out):
                demo.main(["--config", "full", "--synthetic", "1", "--viz",
                           png] + dev)
        finally:
            demo.draw_bev = draw_bev
        head = out.getvalue().splitlines()[0]
        if not head.startswith("frame 000000:"):
            raise RuntimeError(f"eval: cli.demo printed {head!r}")
        red = demo_viz_check(png, drawn[0])
        log(f"eval: cli.demo --config full --viz: {head}; {red}")

        out = io.StringIO()
        debug_dir = os.path.join(work, "debug")
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train.main(["--config", "tiny", "--synthetic", "4", "--steps",
                        "1", "--debug", "--workdir", debug_dir] + dev)
        with open(os.path.join(debug_dir, "metrics.jsonl")) as f:
            (m,) = [json.loads(line) for line in f]
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])) \
                or not os.path.exists(os.path.join(
                    debug_dir, "checkpoints", "ckpt_00000001.pt")):
            raise RuntimeError(f"eval: cli.train --debug logged {m}")
        log(f"eval: cli.train --config tiny --debug --steps 1 on the card "
            f"(anomaly detection, finite checks) in "
            f"{time.perf_counter() - t:.1f} s: loss {m['loss']:.4f}, "
            f"grad_norm {m['grad_norm']:.4f}")
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def demo_viz_check(png: str, drawn: dict) -> str:
    """The demo's BEV PNG decoded back by data/png.py: the voxel range's
    size at 10 px a metre, and red on the outline of the highest-scoring
    detection (one of its corners' pixels, red over whatever lay
    beneath: R above G and B by 20)."""
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data.png import read_png
    from dcf_torch.geometry.np_boxes import box_corners_bev
    from dcf_torch.utils.viz import bev_pixels
    vox = multi_scale_config().voxel
    img = read_png(png)
    want = (int(round((vox.x_max - vox.x_min) * 10)),
            int(round((vox.y_max - vox.y_min) * 10)), 3)
    if img.shape != want:
        raise RuntimeError(f"demo --viz: {img.shape}, expected {want}")
    boxes, scores = drawn["det_boxes"], drawn["det_scores"]
    if len(boxes) == 0:
        raise RuntimeError("demo --viz: no detection drawn")
    k = int(np.argmax(scores))
    corners = np.floor(bev_pixels(box_corners_bev(
        boxes[k:k + 1, [0, 1, 3, 4, 6]])[0], vox, 10.0)).astype(int)
    inside = [(r, c) for r, c in corners
              if 0 <= r < img.shape[0] and 0 <= c < img.shape[1]]
    reds = [tuple(int(v) for v in img[r, c]) for r, c in inside
            if int(img[r, c, 0]) > int(img[r, c, 1]) + 20
            and int(img[r, c, 0]) > int(img[r, c, 2]) + 20]
    if not reds:
        raise RuntimeError(f"demo --viz: no red on the corners {inside} of "
                           f"the top detection (score {scores[k]:.3f})")
    return (f"{os.path.basename(png)} {img.shape[1]}x{img.shape[0]}, "
            f"{len(boxes)} detections drawn, the top one (score "
            f"{scores[k]:.3f}) red at {len(reds)} of its {len(inside)} "
            f"corner pixels {reds}")


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
    readings = {"detect_s": detect_s / n, "infer_s": sum(infer_s) / n,
                "host_all_s": host_s["all"] / n,
                "host_trained_s": host_s["trained"] / n,
                "dets_all": n_det["all"] / n,
                "dets_trained": n_det["trained"] / n}
    log(f"eval timing: run_eval halves at full width, bf16, {n} frames at "
        f"batch 8, {sum(len(g) for g in gts)} gt boxes: detect "
        f"{detect_s / n:.4f} s a frame (inference {sum(infer_s) / n:.4f} s "
        f"a frame, synchronized, {len(infer_s)} batches; host "
        f"preprocessing and conversion the rest); host evaluation (IoU and "
        f"matching, 3d + bev, R40) {host_s['all'] / n:.4f} s a frame with "
        f"every detection ({n_det['all'] / n:.1f} a frame, the upper "
        f"bound), {host_s['trained'] / n:.4f} s a frame with a trained "
        f"model's count ({n_det['trained'] / n:.1f} a frame)")
    return readings, gts, dets


def _p50_ms(fn, reps: int):
    """(p50 host ms of `reps` calls of fn, the last result)."""
    ms = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t) * 1e3)
    return float(np.percentile(ms, 50)), out


def _filtered_png(image, ftype: int) -> bytes:
    """An 8-bit RGB PNG of `image` with every row filtered by `ftype`
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); the port's encoder
    writes Sub only."""
    import struct
    import zlib
    from dcf_torch.data import png
    H, W, C = image.shape
    x = image.reshape(H, W * C).astype(np.int32)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, C:], b[1:], c[1:, C:] = x[:, :-C], x[:-1], x[:-1, :-C]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = (0 * x, a, b, (a + b) >> 1,
            np.where((pa <= pb) & (pa <= pc), a,
                     np.where(pb <= pc, b, c)))[ftype]
    rows = np.concatenate([np.full((H, 1), ftype, np.uint8),
                           ((x - pred) % 256).astype(np.uint8)], axis=1)
    return (png._SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0,
                                              0))
            + png._chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + png._chunk(b"IEND", b""))


def host_core(device, smi: str, build_log: str, eval_readings, gts, dets):
    """Phase 13: the compiled host core (`dcf_torch.native`) on the card's
    host: every entry point against its plain version on a KITTI tree's
    frames and phase 12's detections, their times, the host readings of
    a frame's path, and 4 frames of the tree served through the kernels.
    Returns the launches of the serving run."""
    import shutil
    import torch
    from dcf_torch import native
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data import png, preprocess as pre
    from dcf_torch.data.kitti import KittiDataset
    from dcf_torch.data.synthetic import write_kitti_tree
    from dcf_torch.data.voxelize import crop_and_pad_plain
    from dcf_torch.eval import kitti_eval as ke
    from dcf_torch.eval.inference import make_inference_fn
    from dcf_torch.geometry import np_boxes
    from dcf_torch.ops.clip import rotated_intersection_area_pairs as clip
    from dcf_torch.ops.fusion import fused_fusion, fused_fusion_bwd
    from dcf_torch.params import init_params
    from dcf_torch.tools.profile_training import load_batches

    log(f"host core: {build_log}")
    cfg = multi_scale_config()
    vox = cfg.voxel
    roi = (vox.x_min, vox.x_max, vox.y_min, vox.y_max, vox.z_min, vox.z_max)
    ms = {}                      # (entry point, unit) -> ([compiled], [plain])
    checked = {}

    def hold(name, unit, compiled, plain, same, reps=(9, 3)):
        """Both versions timed (p50 over reps); raise unless same()."""
        c_ms, got = _p50_ms(compiled, reps[0])
        p_ms, want = _p50_ms(plain, reps[1])
        if not same(got, want):
            raise RuntimeError(f"host core: {name} differs from its plain "
                               f"version")
        c, p = ms.setdefault((name, unit), ([], []))
        c.append(c_ms)
        p.append(p_ms)
        checked[name] = checked.get(name, 0) + 1
        return got

    def equal(a, b):
        if isinstance(a, tuple):
            return len(a) == len(b) and all(map(equal, a, b))
        return np.array_equal(a, b)

    def within(tol):
        return lambda a, b: a.shape == b.shape and (
            a.size == 0 or float(np.abs(a - b).max()) <= tol)

    work = os.path.join(HERE, "_host_smoke")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "kitti")
    try:
        ids = write_kitti_tree(root, num_frames=4, split="val")
        ds = KittiDataset(root, "val")
        # the PNGs: each frame's file (Sub rows, the port's encoder) and
        # frame 0's image with every row None, Sub, Up, Average, Paeth
        files = []
        for fid in ids:
            with open(os.path.join(root, "training", "image_2",
                                   fid + ".png"), "rb") as f:
                files.append(f.read())
        image0 = png.read_png(os.path.join(root, "training", "image_2",
                                           ids[0] + ".png"))
        files += [_filtered_png(image0, t) for t in range(5)]
        for k, data in enumerate(files):
            rows, W, C = png._filtered_rows(data)
            H = len(rows)
            hold("png_unfilter", f"a {H}x{W} image",
                 lambda: native.png_unfilter(rows, C).reshape(H, W, C),
                 lambda: png._unfilter(rows[:, 1:].reshape(H, W, C),
                                       rows[:, 0]), equal, reps=(9, 1))
            got = hold("read_png (inflate + unfilter)", f"a {H}x{W} file",
                       lambda: png.decode_png(data),
                       lambda: png.decode_png_plain(data), equal,
                       reps=(9, 1))
            if k >= len(ids) and not np.array_equal(got, image0):
                raise RuntimeError(f"host core: filter {k - len(ids)} "
                                   f"file decodes to other pixels")

        # a frame's path, at the config's full size
        frames = [ds[i] for i in range(len(ds))]
        rng = np.random.default_rng(13)
        sweep = np.concatenate([rng.uniform(-80, 80, (120_000, 2)),
                                rng.uniform(-3, 2, (120_000, 1)),
                                rng.uniform(0, 1, (120_000, 1))],
                               axis=1).astype(np.float32)
        for cloud in [f.points for f in frames] + [sweep]:
            out, mask = hold(
                "crop_pad", f"{len(cloud)} points",
                lambda: native.crop_pad(cloud, roi, vox.max_points),
                lambda: crop_and_pad_plain(cloud, vox), equal)
            if mask.all():
                raise RuntimeError("host core: the crop overflowed")
        # gt-sampling's points-in-boxes test: each frame against its own
        # boxes, the sweep against 24 boxes (gt-sampling pastes 18-28)
        brng = np.random.default_rng(14)
        boxes24 = np.concatenate([
            brng.uniform([0, -30, -2], [70, 30, -1], (24, 3)),
            brng.uniform([1, 0.5, 1.4], [5, 2, 2], (24, 3)),
            brng.uniform(-np.pi, np.pi, (24, 1))], axis=1).astype(np.float32)
        for cloud, boxes, unit in (
                [(f.points, f.boxes, "a frame against its boxes")
                 for f in frames]
                + [(sweep, boxes24, "120000 points x 24 boxes")]):
            hold("points_in_boxes3d", unit,
                 lambda: native.points_in_boxes3d(cloud[:, :3], boxes),
                 lambda: np_boxes.points_in_boxes3d(cloud[:, :3], boxes),
                 equal, reps=(9, 1))
        # the union over boxes, as gt-sampling asks for it
        hold("points_in_boxes3d any_box", "120000 points x 24 boxes",
             lambda: native.points_in_boxes3d(sweep[:, :3], boxes24,
                                              any_box=True),
             lambda: np_boxes.points_in_boxes3d(sweep[:, :3],
                                                boxes24).any(axis=1),
             equal, reps=(9, 1))
        def prepare_plain(image):
            full, scale = pre.prepare_image(image, cfg)
            return pre.s2d_image(full), scale

        for f in frames:
            hold("image_resize_s2d", "a 375x1242 frame",
                 lambda: pre.prepare_image_s2d(f.image, cfg),
                 lambda: prepare_plain(f.image), equal)
            pts, mask = native.crop_pad(f.points, roi, vox.max_points)
            pts, mask = hold(
                "sort_points_fine", f"{vox.max_points} points",
                lambda: pre.sort_points_host(pts, mask, cfg),
                lambda: pre.sort_points_host_plain(pts, mask, cfg), equal)
            v2i = f.calib.velo_to_image_matrix.copy()
            v2i[:2] *= pre._fit_size(f.image.shape, cfg)[2]
            m = v2i.astype(np.float32)
            uvw = pts[:, :3] @ m[:, :3].T + m[:, 3]
            uvz = hold("uvw_to_uvz", f"{vox.max_points} points",
                       lambda: native.uvw_to_uvz(uvw),
                       lambda: pre.uvw_to_uvz_plain(uvw), equal)
            hold("fusion_ranks", f"{vox.max_points} points x 4 scales",
                 lambda: native.fusion_ranks(
                     pts, mask, uvz, cfg.backbone.fusion_strides, vox.x_min,
                     vox.y_min, vox.voxel_size, vox.grid_x, vox.grid_y,
                     cfg.image.height, cfg.image.width),
                 lambda: pre.fusion_ranks_plain(pts, mask, uvz, cfg), equal)

        # evaluation, on phase 12's detections (128 a frame)
        for g, d in zip(gts, dets):
            if not len(d) or not len(g):
                continue
            bev = [0, 1, 3, 4, 6]
            bev_d, bev_g = d.boxes7[:, bev], g.boxes7[:, bev]
            unit = f"a frame, {len(d)} detections"
            bev = hold("rotated_iou_bev", unit,
                       lambda: native.rotated_iou_bev(bev_d, bev_g),
                       lambda: np_boxes.rotated_iou_bev(bev_d, bev_g),
                       within(1e-9), reps=(9, 1))
            iou = hold("iou_3d", unit,
                       lambda: native.iou_3d(d.boxes7, g.boxes7),
                       lambda: np_boxes.iou_3d(d.boxes7, g.boxes7),
                       within(1e-9), reps=(9, 1))
            thr = np.quantile(d.scores, np.linspace(1, 0, 41))
            for cls in ke.CLASS_NAMES:
                _, ig_gt, ig_det, _ = ke._clean_data(g, d, cls, 1)
                for overlaps, alphas in ((iou, None), (bev, (g.alpha,
                                                             d.alpha))):
                    ga, da = alphas or (None, None)
                    hold("eval_statistics", f"a frame and cell, "
                         f"{len(thr)} thresholds",
                         lambda: native.eval_statistics(
                             overlaps, d.scores, ig_gt, ig_det, None, 0.7,
                             thr, ga, da),
                         lambda: tuple(np.array(v) for v in zip(*[
                             ke._frame_statistics(
                                 overlaps, d.scores, ig_gt, ig_det, None,
                                 0.7, t, gt_alphas=ga, dt_alphas=da)
                             for t in thr])), equal, reps=(9, 1))
        log(f"host core: compiled against plain, bit-equal (the IoUs "
            f"within 1e-9): " + ", ".join(f"{k} {v}" for k, v in
                                          checked.items()) + " inputs")

        # a frame's host readings
        f2e_ms, _ = _p50_ms(lambda: [pre.frame_to_example(f, cfg)
                                     for f in frames], 5)
        _, _, load_ms, workers = load_batches(9)
        log(f"host core times (card {smi}; host p50 ms, compiled / plain):")
        for (name, unit), (c, p) in ms.items():
            print(f"    {name:30s} {np.median(c):10.4f} / {np.median(p):10.4f}"
                  f" ms  ({unit}; x{np.median(p) / np.median(c):.1f})",
                  flush=True)
        log(f"host core: frame_to_example {f2e_ms / len(frames):.4f} ms a "
            f"375x1242 frame; run_eval (phase 12, bf16, batch 8): detect "
            f"{eval_readings['detect_s']:.4f} s a frame, of which inference "
            f"{eval_readings['infer_s']:.4f} s and host preprocessing "
            f"{eval_readings['detect_s'] - eval_readings['infer_s']:.4f} s; "
            f"host evaluation {eval_readings['host_all_s']:.4f} s a frame at "
            f"{eval_readings['dets_all']:.1f} detections, "
            f"{eval_readings['host_trained_s']:.4f} s at "
            f"{eval_readings['dets_trained']:.1f}; the loader "
            f"{load_ms:.3f} ms per batch of 2 ({workers} workers, "
            f"profile_training's reading)")

        # the tree's frames served through the kernels
        model = init_params(cfg, torch.Generator().manual_seed(0),
                            device=device)
        infer = make_inference_fn(cfg, model, device=device)
        infer(pre.stack_examples([pre.frame_to_example(frames[0], cfg)]))
        torch.cuda.synchronize()
        fused_fusion.launches = fused_fusion_bwd.launches = 0
        clip.launches = 0
        n_valid = 0
        for f in frames:
            dets_f = infer(pre.stack_examples([pre.frame_to_example(f, cfg)]))
            if not all(torch.isfinite(dets_f[k]).all()
                       for k in ("boxes", "scores")):
                raise RuntimeError("host core: non-finite detections")
            n_valid += int(dets_f["valid"].sum())
        torch.cuda.synchronize()
        launches = {"fusion_fwd": fused_fusion.launches,
                    "fusion_bwd": fused_fusion_bwd.launches,
                    "clip_pairs": clip.launches}
        n = len(frames)
        expect = {"fusion_fwd": 4 * n, "fusion_bwd": 0, "clip_pairs": n}
        if launches != expect:
            raise RuntimeError(f"host core: serving launches {launches} != "
                               f"{expect}")
        log(f"host core: {n} frames of the tree served through the compiled "
            f"host path, multi_scale_config bf16 at B=1: finite, {n_valid} "
            f"valid detections, launches {launches}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def _dp_config(batch_size: int):
    """Phase 14's config: tiny_config in float32 with EMA and without
    augmentation, so batches depend on the frames alone (a per-process
    batch of 1 on two ranks sees what one process sees at 2)."""
    import dataclasses
    from dcf_torch.config import tiny_config
    cfg = tiny_config(True)
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="float32"),
        augment=dataclasses.replace(cfg.augment, flip_prob=0.0,
                                    gt_sampling=False, global_rotation=0.0,
                                    global_scale=(1.0, 1.0)),
        train=dataclasses.replace(cfg.train, batch_size=batch_size,
                                  num_steps=DP_STEPS, ema_decay=0.5,
                                  checkpoint_every=1000, log_every=1))


def _dp_frames():
    """Two frames with 3 and 1 boxes (different num_pos), small enough
    that crop_and_pad never subsamples them."""
    from dcf_torch.data.synthetic import make_frame
    return [make_frame("000000", n_ground=1200, pts_per_box=100, seed=0),
            make_frame("000001", boxes=[("Car", 12.0, -3.0, 0.5)],
                       n_ground=1200, pts_per_box=100, seed=1)]


def _dp_train(batch_size: int, workdir: str, **kw):
    """train() of _dp_config on the card, TF32 off, returning the state
    and the launches (fusion forward, backward, clip) of the run."""
    import torch
    from dcf_torch.ops.clip import rotated_intersection_area_pairs as clip
    from dcf_torch.ops.fusion import fused_fusion, fused_fusion_bwd
    from dcf_torch.train.loop import train
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fused_fusion.launches = fused_fusion_bwd.launches = 0
    clip.launches = 0
    try:
        state = train(_dp_config(batch_size), _dp_frames(), workdir,
                      device="cuda", num_steps=DP_STEPS, **kw)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return state, {"fusion_fwd": fused_fusion.launches,
                   "fusion_bwd": fused_fusion_bwd.launches,
                   "clip_pairs": clip.launches}


def _frame_num_pos():
    """num_pos of each of phase 14's frames alone, on the card (targets
    depend on the frame, not on the weights)."""
    import torch
    from dcf_torch.data.preprocess import frame_to_example, stack_examples
    from dcf_torch.eval.inference import batch_to_device
    from dcf_torch.models.anchors import anchor_pack
    from dcf_torch.params import init_params
    from dcf_torch.train.step import build_loss_sums_fn
    cfg = _dp_config(1)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    sums_fn = build_loss_sums_fn(cfg, model)
    pack = anchor_pack(cfg, "cuda")
    with torch.no_grad():
        return [float(sums_fn(batch_to_device(stack_examples(
            [frame_to_example(f, cfg)]), "cuda"), pack)[1]["num_pos"])
            for f in _dp_frames()]


def data_parallel_rank(rank: int, world: int, port: str, workdir: str,
                       out: str) -> int:
    """One rank of phase 14, in its own process: joins the gloo group,
    trains its stride of the frames on the card and saves its final
    parameters, EMA and launches to `out`/rank<rank>.pt."""
    import torch
    import torch.distributed as dist
    from dcf_torch.parallel import mesh
    if not mesh.initialize_distributed(f"localhost:{port}", world, rank,
                                       backend="gloo"):
        raise RuntimeError("data parallel: no process group")
    try:
        state, launches = _dp_train(1, workdir, num_data_shards=world)
        torch.save({"step": state.step, "launches": launches,
                    "params": {n: p.detach().cpu() for n, p in
                               state.model.named_parameters()},
                    "ema": {n: e.cpu() for n, e in state.ema.items()}},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def data_parallel():
    """Phase 14: two ranks on the one card through gloo (NCCL needs a
    card per rank), one frame each, against a single-process B=2 run on
    the card. Returns the ranks' launches (the `data_parallel` path)."""
    import json as _json
    import shutil
    import socket
    import torch
    work = os.path.join(HERE, "_dp_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = str(sock.getsockname()[1])
        env = {k: v for k, v in os.environ.items() if k not in (
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
        t = time.time()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--data-parallel-rank", str(r), "2", port,
             os.path.join(work, f"rank{r}"), work], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"data parallel: rank {r} exited "
                                   f"{p.returncode}:\n{out[-3000:]}")
        ranks_s = time.time() - t
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=True) for r in range(2)]
        local = _frame_num_pos()
        if local[0] == local[1]:
            raise RuntimeError(f"data parallel: the ranks' frames have "
                               f"equal num_pos {local}")
        sp_dir = os.path.join(work, "single")
        sp, sp_launches = _dp_train(2, sp_dir)

        def metrics(d):
            with open(os.path.join(d, "metrics.jsonl")) as f:
                return [_json.loads(line) for line in f]
        got, want = metrics(os.path.join(work, "rank0")), metrics(sp_dir)
        ckpts = os.listdir(os.path.join(work, "rank0", "checkpoints"))
        rank1_wrote = os.path.exists(os.path.join(work, "rank1"))
        if f"ckpt_{DP_STEPS:08d}.pt" not in ckpts or rank1_wrote:
            raise RuntimeError(f"data parallel: rank 0 wrote {ckpts}; rank "
                               f"1's workdir exists: {rank1_wrote}")
        if len(got) != DP_STEPS or any(
                g["num_pos"] != w["num_pos"] or any(
                    abs(g[k] - w[k]) > DP_METRIC_RTOL * abs(w[k])
                    for k in ("loss", "grad_norm"))
                for g, w in zip(got, want)):
            raise RuntimeError(f"data parallel: rank 0 logged {got}, the "
                               f"single process {want}")
        for tree in ("params", "ema"):
            for name in ranks[0][tree]:
                if not torch.equal(ranks[0][tree][name],
                                   ranks[1][tree][name]):
                    raise RuntimeError(f"data parallel: ranks differ in "
                                       f"{tree} {name}")
        worst, near, n = 0.0, 0, 0
        sp_trees = {"params": {k: v.detach().cpu() for k, v in
                               sp.model.named_parameters()},
                    "ema": {k: v.cpu() for k, v in sp.ema.items()}}
        for tree in ("params", "ema"):
            for name, g in ranks[0][tree].items():
                d = (g - sp_trees[tree][name]).abs()
                worst = max(worst, d.max().item())
                near += int((d > DP_NEAR).sum())
                n += d.numel()
        if worst > DP_ATOL or near > DP_NEAR_SHARE * n:
            raise RuntimeError(f"data parallel: parameters and EMA against "
                               f"the single process: max|err| {worst}, "
                               f"{near} of {n} elements beyond {DP_NEAR}")
        launches = {k: ranks[0]["launches"][k] + ranks[1]["launches"][k]
                    for k in ranks[0]["launches"]}
        per_rank = {"fusion_fwd": 4 * DP_STEPS, "fusion_bwd": 4 * DP_STEPS,
                    "clip_pairs": DP_STEPS}
        if any(r["launches"] != per_rank for r in ranks) or \
                sp_launches != per_rank:
            raise RuntimeError(f"data parallel: launches per rank "
                               f"{[r['launches'] for r in ranks]}, single "
                               f"process {sp_launches}, expected {per_rank}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"data parallel: 2 gloo ranks on one card (NCCL needs a card per "
        f"rank: not exercised), tiny_config float32, TF32 off, "
        f"{DP_STEPS} steps, one frame a rank (num_pos {local} a rank, "
        f"{[m['num_pos'] for m in got]} global), {ranks_s:.1f} s with "
        f"process start; ranks bit-equal; against one process at B=2: "
        f"loss {[round(m['loss'], 6) for m in got]} / "
        f"{[round(m['loss'], 6) for m in want]}, grad_norm "
        f"{[round(m['grad_norm'], 4) for m in got]} / "
        f"{[round(m['grad_norm'], 4) for m in want]} (within rtol "
        f"{DP_METRIC_RTOL}), parameters and EMA max|err| {worst:.3g} (atol "
        f"{DP_ATOL}), {near} of {n} elements beyond {DP_NEAR}; rank 0 alone "
        f"wrote ckpt_{DP_STEPS:08d}.pt and metrics.jsonl; launches "
        f"{launches} ({per_rank} a rank)")
    return launches


CLASSES = ("Car", "Pedestrian", "Cyclist")
# the keys of scripts/generalization.py's generalization.json
GEN_KEYS = ({f"{c}_{m}_{d}_{tag}" for c in CLASSES for m in ("3d", "bev")
             for d in ("easy", "moderate") for tag in ("R40", "exact")}
            | {f"{c}_3d_moderate_{tag}" for c in CLASSES
               for tag in ("ema_exact", "best_exact")}
            | {f"{c}_{m}_moderate_int8_exact" for c in CLASSES
               for m in ("3d", "bev")}
            | {"best_step", "best_kind"})


def generalization():
    """Phase 15: the train-and-evaluate workflow at full width through
    `python -m dcf_torch.tools.generalization`'s main: 20 steps on 8
    train frames, 4 val frames, probe evaluations every 10 steps on 2
    frames, EMA, gt-sampling and the int8 evaluation. Returns the
    launches (the `generalization` path)."""
    import shutil
    import torch
    from dcf_torch.ops.clip import rotated_intersection_area_pairs as clip
    from dcf_torch.ops.fusion import fused_fusion, fused_fusion_bwd
    from dcf_torch.tools import generalization as gen
    steps, n_train, n_val, every, n_probe = 20, 8, 4, 10, 2
    work = os.path.join(HERE, "_gen_smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        fused_fusion.launches = fused_fusion_bwd.launches = 0
        clip.launches = 0
        t = time.time()
        results = gen.main([
            "--steps", str(steps), "--train-frames", str(n_train),
            "--val-frames", str(n_val), "--eval-every", str(every),
            "--probe-frames", str(n_probe), "--ema", "0.999", "--gt-db",
            "--int8-eval", "--workdir", work, "--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.time() - t
        launches = {"fusion_fwd": fused_fusion.launches,
                    "fusion_bwd": fused_fusion_bwd.launches,
                    "clip_pairs": clip.launches}
        with open(os.path.join(work, "generalization.json")) as f:
            written = json.load(f)
        with open(os.path.join(work, "eval_curve.json")) as f:
            curve = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if written != results or set(written) != GEN_KEYS:
        raise RuntimeError(f"generalization: keys {sorted(written)}")
    aps = {k: v for k, v in written.items()
           if k not in ("best_step", "best_kind")}
    if not all(0.0 <= v <= 1.0 for v in aps.values()) or \
            written["best_kind"] not in ("raw", "ema") or \
            [row["step"] for row in curve] != [every, 2 * every]:
        raise RuntimeError(f"generalization: {written}, curve {curve}")
    # served batches (one each: at most 8 frames): 2 probe evaluations x
    # raw and EMA, val R40 / exact / EMA / best, the int8 val; plus the
    # 4 calibration batches (forward only) and the training steps
    served = 2 * 2 + 4 + 1
    expect = {"fusion_fwd": 4 * (steps + served + 4),
              "fusion_bwd": 4 * steps, "clip_pairs": steps + served}
    if launches != expect:
        raise RuntimeError(f"generalization: launches {launches} != "
                           f"{expect}")
    log(f"generalization: multi_scale_config, {steps} steps (B=2, EMA "
        f"0.999, gt-sampling), {n_train} train / {n_val} val / {n_probe} "
        f"probe frames, probe evaluations every {every} steps, int8 "
        f"evaluation, in {secs:.1f} s; both files carry the JAX script's "
        f"{len(GEN_KEYS)} keys, APs in [0, 1]; best {written['best_kind']} "
        f"at step {written['best_step']}; curve {curve}; val exact moderate "
        f"3d (bf16) {[aps[f'{c}_3d_moderate_exact'] for c in CLASSES]}; "
        f"launches {launches}")
    return launches


PP_GROUND = (4000, 11000, 18000)   # the serving mix's ground points
PP_HEAPED = 200                    # pillars the heaped cloud fills


def pp_clouds(cfg):
    """Phase 16's cropped clouds ([1, Pts, 4] float32, [1, Pts] bool, on
    the CPU): three synthetic frames, then the crop's full point count
    spread over the ROI and heaped into PP_HEAPED pillars."""
    import torch
    from dcf_torch.data.synthetic import make_varied_frame
    from dcf_torch.models.pointpillars import pillar_example
    vox = cfg.voxel
    out = []
    for i, n in enumerate(PP_GROUND):
        ex = pillar_example(make_varied_frame(seed=i, n_ground=n), cfg)
        out.append((f"{n} ground", ex["points"], ex["point_mask"]))
    rng = np.random.default_rng(16)
    n = vox.max_points
    u = rng.uniform(0.02, 0.98, (n, 2))
    spread = np.stack([u[:, 0] * (vox.x_max - vox.x_min) + vox.x_min,
                       u[:, 1] * (vox.y_max - vox.y_min) + vox.y_min,
                       rng.uniform(vox.z_min, vox.z_max - 0.5, n),
                       rng.uniform(0, 1, n)], 1)
    cells = rng.choice(vox.grid_x * vox.grid_y, PP_HEAPED, replace=False)
    pick = cells[rng.integers(0, PP_HEAPED, n)]
    heaped = spread.copy()
    heaped[:, 0] = (pick // vox.grid_y + u[:, 0]) * vox.voxel_size + vox.x_min
    heaped[:, 1] = (pick % vox.grid_y + u[:, 1]) * vox.voxel_size + vox.y_min
    full = np.ones(n, bool)
    out += [("spread", spread, full), ("heaped", heaped, full)]
    return [(name, torch.from_numpy(np.asarray(p, np.float32)[None]),
             torch.from_numpy(m[None])) for name, p, m in out]


def check_pillars(device):
    """Phase 16, the kernels: pillarize and pfn_scatter against their
    plain versions on the card at the network's shapes."""
    import torch
    from dcf_torch.models.pointpillars import (PillarConfig,
                                               pointpillars_config)
    from dcf_torch.ops import pillars
    from perfbench.families.pointpillars import pfn_bytes, pillarize_bytes
    cfg, pc = pointpillars_config(), PillarConfig()
    vox, P, N, C = cfg.voxel, pc.max_pillars, pc.max_points, pc.features
    shape = (1, vox.grid_x, vox.grid_y, C)
    g = torch.Generator().manual_seed(16)
    w = torch.randn(pillars.NUM_FEATURES, C, generator=g).to(device)
    b = (0.1 * torch.randn(C, generator=g)).to(device)
    canvas = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    rows = []
    for name, pts, mask in pp_clouds(cfg):
        pts, mask = pts.to(device), mask.to(device)
        args = (pts, mask, vox, P, N)
        t = pillars.pillarize(*args)
        want = pillars.pillarize_plain(*args)
        for f in t._fields:
            if not torch.equal(getattr(t, f), getattr(want, f)):
                raise RuntimeError(f"pillarize ({name}): {f} differs from "
                                   f"the plain version")
        got = pillars.pfn_scatter(pts, t, w, b, vox, canvas.zero_()).clone()
        ref = pillars.pfn_scatter_plain(
            pts, want, w, b, vox,
            torch.zeros(shape, dtype=torch.bfloat16, device=device))
        if not torch.equal(got, ref):
            raise RuntimeError(f"pfn_scatter ({name}): the canvas differs "
                               f"from the plain version in "
                               f"{int((got != ref).sum())} elements")
        in_roi, kept, non_empty = t.stats[0].tolist()
        rows.append({
            "cloud": name, "in_roi": in_roi, "non_empty": non_empty,
            "points_dropped": in_roi - kept,
            "full_pillars": int((t.counts == N).sum()),
            "pillarize_ms": graph_ms(lambda: pillars.pillarize(*args)),
            "pillarize_plain_ms": cuda_ms(
                lambda: pillars.pillarize_plain(*args), 5),
            "pillarize_bound_ms": bound_ms(
                float(pillarize_bytes(args, t)), 0)[0],
            "pfn_ms": graph_ms(lambda: pillars.pfn_scatter(
                pts, t, w, b, vox, canvas)),
            "pfn_plain_ms": cuda_ms(lambda: pillars.pfn_scatter_plain(
                pts, want, w, b, vox, canvas), 5),
            "pfn_bound_ms": bound_ms(float(pfn_bytes(
                (pts, t, w, b, vox, canvas), canvas)), 0)[0]})
        log(f"pillars ({name}): {json.dumps(rows[-1])}")
    by = {r["cloud"]: r for r in rows}
    main = by[f"{PP_GROUND[-1]} ground"]
    if main["non_empty"] <= P or by["spread"]["non_empty"] <= P or \
            by["heaped"]["full_pillars"] == 0 or \
            by["heaped"]["non_empty"] > P:
        raise RuntimeError(f"pillars: the caps do not bind as meant: "
                           f"{rows}")
    entries = []
    for k, name in (("pillarize", "pillarize"), ("pfn", "pfn_scatter")):
        entries.append({
            "name": name, "route": "cuda",
            "source": "dcf_torch/csrc/pillars.cu", "replaces": None,
            "ms": main[f"{k}_ms"], "plain_ms": main[f"{k}_plain_ms"],
            "bound_ms": main[f"{k}_bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "by_cloud": {r["cloud"]: [r[f"{k}_ms"], r[f"{k}_plain_ms"],
                                      r[f"{k}_bound_ms"]] for r in rows}})
    log(f"pillars: {len(rows)} clouds, both kernels bit-equal to their "
        f"plain versions (P {P}, N {N}, C {C}, bf16 canvas); ms, plain ms, "
        f"bound ms of the {main['cloud']} frame: pillarize "
        f"{main['pillarize_ms']:.4f} / {main['pillarize_plain_ms']:.3f} / "
        f"{main['pillarize_bound_ms']:.5f}, PFN + scatter "
        f"{main['pfn_ms']:.4f} / {main['pfn_plain_ms']:.3f} / "
        f"{main['pfn_bound_ms']:.5f}")
    return entries


def serve_pointpillars(device):
    """Phase 16, the path: 8 PointPillars frames through
    `make_inference_fn`, launches counted, then again with the tracer on
    for the host syncs and pillar counters. Returns the launches."""
    import torch
    from dcf_torch.data.preprocess import stack_examples
    from dcf_torch.data.synthetic import make_varied_frame
    from dcf_torch.eval.inference import make_inference_fn
    from dcf_torch.models.pointpillars import (init_pointpillars,
                                               pillar_example,
                                               pointpillars_config)
    from dcf_torch.ops import pillars
    from dcf_torch.ops.clip import rotated_intersection_area_pairs as clip
    from dcf_torch.utils import trace
    cfg = pointpillars_config()
    model = init_pointpillars(cfg, torch.Generator().manual_seed(0),
                              device=device)
    infer = make_inference_fn(cfg, model, device=device)
    batches = [stack_examples([pillar_example(make_varied_frame(
        seed=s, n_ground=4000 + 2000 * s), cfg)]) for s in range(9)]
    infer(batches[-1])                              # warm-up frame
    torch.cuda.synchronize()
    pillars.pillarize.launches = pillars.pfn_scatter.launches = 0
    clip.launches = 0
    times, n_valid = [], 0
    for batch in batches[:-1]:
        t = time.perf_counter()
        dets = infer(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if not torch.isfinite(dets["boxes"]).all() or \
                not torch.isfinite(dets["scores"]).all():
            raise RuntimeError("pointpillars: non-finite detections")
        n_valid += int(dets["valid"].sum())
    n = len(times)
    launches = {"pillarize": pillars.pillarize.launches,
                "pfn_scatter": pillars.pfn_scatter.launches,
                "clip_pairs": clip.launches}
    expect = {"pillarize": n, "pfn_scatter": n, "clip_pairs": n}
    if launches != expect:
        raise RuntimeError(f"pointpillars launches {launches} != {expect}")
    trace.reset()
    trace.enable()
    try:
        for batch in batches[:-1]:
            infer(batch)
        torch.cuda.synchronize()
        c = trace.snapshot()["counters"]
    finally:
        trace.enable(False)
        trace.reset()
    if c["host_syncs"] > c["nms.rounds"] + n:
        raise RuntimeError(f"pointpillars: {c['host_syncs']} host syncs for "
                           f"{c['nms.rounds']} NMS rounds in {n} frames")
    log(f"pointpillars: {n} frames at B=1 (4,000-18,000 ground points), "
        f"{sum(p.numel() for p in model.parameters())} params, p50 "
        f"{np.percentile(times, 50):.3f} ms, p95 "
        f"{np.percentile(times, 95):.3f} ms, {n_valid} valid detections, "
        f"launches {launches}; traced: host syncs {c['host_syncs']:.0f}, "
        f"NMS rounds {c['nms.rounds']:.0f}, pillars kept "
        f"{c['pillars.kept']:.0f} / dropped {c['pillars.dropped']:.0f}, "
        f"points in the ROI {c['pillars.points_in_roi']:.0f} / dropped "
        f"{c['pillars.points_dropped']:.0f}")
    return launches


def serve_graphs(device):
    """Phase 17, the path: 8 frames served eager, then as served (graphs
    replayed from the third frame on), compared frame by frame. Returns
    the graphed pass's launches."""
    import torch
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data.preprocess import frame_to_example, stack_examples
    from dcf_torch.data.synthetic import make_varied_frame
    from dcf_torch.eval.inference import make_inference_fn, to_host
    from dcf_torch.ops.clip import rotated_intersection_area_pairs as clip
    from dcf_torch.ops.fusion import fused_fusion
    from dcf_torch.params import init_params
    from dcf_torch.utils import trace
    cfg = multi_scale_config()
    model = init_params(cfg, torch.Generator().manual_seed(0), device=device)
    infer = make_inference_fn(cfg, model, device=device)
    batches = [stack_examples([frame_to_example(make_varied_frame(seed=s),
                                                cfg)]) for s in range(8)]
    n = len(batches)
    maps, calls = [], {"image_backbone": 0, "fusion": 0}

    def counter(key):
        return lambda _m, _a, _o: calls.__setitem__(key, calls[key] + 1)
    hooks = [model.register_forward_hook(lambda _m, _a, o: maps.append(o)),
             model.image_backbone.register_forward_hook(
                 counter("image_backbone"))]
    hooks += [m.register_forward_hook(counter("fusion"))
              for name, m in model.named_children()
              if name.startswith("fusion_s")]

    def served():
        maps.clear()
        for k in calls:
            calls[k] = 0
        fused_fusion.launches = clip.launches = 0
        trace.reset()
        trace.enable()
        try:
            dets = [to_host(infer(b)) for b in batches]
            snap = trace.snapshot()
        finally:
            trace.enable(False)
            trace.reset()
        ms = [s["dur_us"] * 1e-3 for s in snap["spans"]
              if s["name"] == "infer.forward"]
        launches = {"fusion_fwd": fused_fusion.launches,
                    "clip_pairs": clip.launches}
        return dets, list(maps), ms, snap["counters"], launches, dict(calls)

    try:
        model.replays = lambda inputs: False       # the forward held eager
        try:
            want_dets, want_maps, eager_ms, c0, _, _ = served()
        finally:
            del model.replays
        torch.cuda.reset_peak_memory_stats()
        dets, got_maps, graph_ms, c, launches, seen = served()
        peak = torch.cuda.max_memory_allocated()
    finally:
        for h in hooks:
            h.remove()
    for i, (got, want) in enumerate(zip(got_maps, want_maps)):
        for k, v in want.items():
            if not torch.equal(got[k], v):
                raise RuntimeError(
                    f"graphs: frame {i}'s {k} map differs from the eager "
                    f"forward's, max|err| {(got[k] - v).abs().max().item()}")
    for i, (got, want) in enumerate(zip(dets, want_dets)):
        for k, v in want.items():
            if not np.array_equal(got[k], v):
                raise RuntimeError(f"graphs: frame {i}'s detections ({k}) "
                                   f"differ from the eager forward's")
    expect = {"graph.captures": 1.0, "graph.forwards": float(n - 2)}
    got_c = {k: c.get(k, 0.0) for k in expect}
    if got_c != expect or any(k in c0 for k in expect):
        raise RuntimeError(f"graphs: counters {got_c} != {expect} (eager "
                           f"pass: {c0})")
    for k in ("fusion.bin_eligible", "fusion.bin_dropped", "fusion.pairs"):
        if c[k] != c0[k]:
            raise RuntimeError(f"graphs: {k} {c[k]} != {c0[k]} eager")
    nf = len(cfg.backbone.fusion_strides)
    if launches != {"fusion_fwd": nf * n, "clip_pairs": n} or \
            seen != {"image_backbone": n, "fusion": nf * n}:
        raise RuntimeError(f"graphs: launches {launches}, module calls "
                           f"{seen} in {n} frames")
    log(f"graphs: {n} frames at B=1, maps bit-equal to the eager forward's "
        f"and detections equal; infer.forward host p50 eager "
        f"{np.percentile(eager_ms, 50):.3f} ms, replayed "
        f"{np.percentile(graph_ms[2:], 50):.3f} ms (capture frame "
        f"{graph_ms[1]:.1f} ms); counters {got_c}, launches {launches}, "
        f"module calls {seen}, peak memory {peak / 2 ** 20:.1f} MiB")
    return launches


def build_host_core() -> str:
    """Phase 13's build (started with phase 2's, since every phase's
    frames go through it): the host core compiled by g++ into
    `dcf_torch/_build/`, then loaded. Returns what it logs."""
    from dcf_torch import native
    t = time.time()
    path = native.build()
    secs = time.time() - t
    native.library()
    return (f"g++ ({native.compiler_version()}) {' '.join(native.FLAGS)}: "
            f"{secs:.1f} s, {os.path.relpath(path, HERE)}")


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--data-parallel-rank"]:        # phase 14's ranks
        rank, world, port, workdir, out = sys.argv[2:7]
        return data_parallel_rank(int(rank), int(world), port, workdir, out)
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
    with ThreadPoolExecutor(1) as pool:      # g++ beside the nvcc processes
        host = pool.submit(build_host_core)
        ptxas = _cuda.build(verbose=True)
        _cuda.library()
        log(f"build: nvcc over {len(_cuda.sources())} sources in "
            f"{time.time() - t:.1f} s")
        host_build = host.result()
    log(f"build: host core {host_build}")
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
    readings, gts, dets = time_eval(device)
    paths["host_core"] = host_core(device, smi, host_build, readings, gts,
                                   dets)
    paths["data_parallel"] = data_parallel()
    paths["generalization"] = generalization()
    kernels += check_pillars(device)
    paths["pointpillars"] = serve_pointpillars(device)
    paths["graphs"] = serve_graphs(device)
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
