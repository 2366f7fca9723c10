"""Training cells: `dcf_torch.train.loop.train` itself, with its
augmenting loader, over a pool of generated frames, and the comparison of
its first steps with the plain reference.

Set-up is the loop's own start (loader, model, optimizer) and its first
`warmup_steps` steps; the window opens after them and closes at the
first step that ends past `--seconds`, both at a device sync. A per-step
hook (`eval_hook`, every step) marks the window, reads the optimizer's
state after step 1 and the parameters after step `check_steps`, and ends
the loop at the window's close. The weights come from the benchmark
(`loop.init_params` returns them), the loop's seed from the run's seed.
"""

from __future__ import annotations

import dataclasses
import gc
import tempfile
from typing import Dict, List

import numpy as np
import torch

from perfbench import registry
from perfbench import spans as spans_mod
from perfbench import trace as trace_mod
from perfbench import traffic_gen, weights as weights_mod
from perfbench.reference import config as ref_config
from perfbench.reference.data import augment as ref_aug
from perfbench.reference.data import preprocess as ref_pre
from perfbench.reference.models import anchors as ref_anchors
from perfbench.reference.models import detector as ref_detector
from perfbench.reference.train import state as ref_state
from perfbench.reference.train import step as ref_step
from perfbench.serve import program_frame, rel_err

B1 = 0.9          # AdamW's first-moment decay (`dcf_torch.train.state`)


MIX_KEYS = ("mode", "batch", "pool", "generator", "warmup_steps",
            "check_steps", "profile_s")


def check_mix(t: Dict) -> None:
    """A training mix has just the keys `run` reads."""
    registry.check_keys(t, MIX_KEYS, "train mix")


class _WindowClosed(Exception):
    pass


def _bwd_bytes(a, out):
    """Bytes the fusion backward's work needs: sel, the features of the
    selected pairs, the cotangent rows of the pixels with a selection, the
    z1 rows of the selected points, d_z1 written whole, wgt / bg read and
    their gradients written."""
    (sel, _geo), z1, wgt, bg = a[0], a[1], a[2], a[3]
    B, P, hid = z1.shape
    live = sel >= 0
    b = torch.arange(B, device=sel.device)[:, None, None, None]
    rows = torch.zeros(B * P, dtype=torch.bool, device=sel.device)
    rows[(b * P + sel.long())[live]] = True
    return (4 * sel.numel() + 16 * live.sum() + 4 * hid * live.any(-1).sum()
            + 4 * hid * rows.sum() + 4 * z1.numel()
            + 8 * (wgt.numel() + bg.numel()))


def _fwd_bytes(a, out):
    """The forward's bytes as serving counts them, plus the stash that
    training writes (per pixel and neighbour an int32 index and four
    float32 features)."""
    data, valid, z1, wgt, bg = a[:5]
    n = valid.sum()
    B, H, W = data.shape[:3]
    k = a[7]
    return (valid.numel() + (16 + 4 * z1.shape[-1]) * n
            + 4 * (wgt.numel() + bg.numel() + out.numel())
            + 20 * B * H * W * k)


def capture_maps(model: torch.nn.Module, store: List[Dict]):
    """A forward hook on `model` that keeps a float32 host copy of each
    call's head maps in `store`; returns its handle."""
    def hook(_m, _a, out):
        store.append({k: v.detach().to("cpu", torch.float32)
                      for k, v in out.items()})
    return model.register_forward_hook(hook)


def joined_maps(store: List[Dict]) -> Dict[str, torch.Tensor]:
    """The head maps of one step's forward calls, joined along the batch."""
    return {k: torch.cat([m[k] for m in store]) for k in store[0]}


def leaf_norms(tensors: List[torch.Tensor]) -> np.ndarray:
    return torch.stack(torch._foreach_norm(
        [t.to(torch.float32) for t in tensors])).double().cpu().numpy()


def run(env) -> Dict:
    import dcf_torch.models.fusion as pfusion
    import dcf_torch.ops.fusion as pops
    import dcf_torch.train.loop as loop
    from dcf_torch.config import Config
    from dcf_torch.data.augment import GTDatabase
    from dcf_torch.models.detector import ContFuseDetector

    t = env.traffic
    check_mix(t)
    cfg = Config.from_json(env.config_json)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=t["batch"], seed=env.seed))
    ref_cfg = ref_config.Config.from_json(env.config_json)
    ref_cfg = dataclasses.replace(ref_cfg, train=dataclasses.replace(
        ref_cfg.train, batch_size=t["batch"], seed=env.seed))
    pool_ref = traffic_gen.make_pool(t["generator"], t["pool"], env.seed)
    pool = [program_frame(f) for f in pool_ref]
    gt_db = GTDatabase.build(pool)
    with torch.device("meta"):
        meta = ref_detector.ContFuseDetector(ref_cfg)
    w = weights_mod.make_weights(meta, env.seed, env.device)
    names = list(w)

    sp = spans_mod.Spans(device_spans=env.trace)
    ranges = trace_mod.OpRanges()
    prof = trace_mod.Profile(env.tmpdir) if env.trace else None
    if env.trace:
        trace_mod.Profile.warm(env.device)
    rec = {"losses": [], "num_pos": [], "batches": [], "step": 0,
           "maps1": []}
    saved = (loop.init_params, loop.make_train_step, loop.infinite_batches,
             pfusion.fused_fusion, pops.fused_fusion_bwd)
    sync = (torch.cuda.synchronize if env.device.type == "cuda"
            else (lambda: None))
    steps_checked = t["check_steps"]

    def init_params(c, _generator, device="cuda"):
        with torch.device(device):
            model = ContFuseDetector(c)
        model = weights_mod.load(model, w).eval()
        rec["model"] = model
        return model

    def make_train_step(c, model, device, debug=False):
        step = saved[1](c, model, device, debug=debug)
        if env.fault is not None:
            step = env.fault(step)
        timed = sp.wrap(step, "step")

        def wrapped(state, batch, pack):
            if rec["losses"]:
                state, metrics = timed(state, batch, pack)
            else:                       # step 1: keep its head maps
                handle = capture_maps(rec["model"], rec["maps1"])
                try:
                    state, metrics = timed(state, batch, pack)
                finally:
                    handle.remove()
            if len(rec["losses"]) < steps_checked:
                rec["losses"].append(metrics["loss"].detach().clone())
                rec["num_pos"].append(metrics["num_pos"].detach().clone())
            return state, metrics
        return wrapped

    def infinite_batches(loader):
        stream = saved[2](loader)
        try:
            while True:
                t0 = spans_mod.host_clock()
                batch = next(stream)
                if rec["step"] >= t["warmup_steps"]:
                    sp.add_host("loader_wait", spans_mod.host_clock() - t0)
                if len(rec["batches"]) < steps_checked:
                    rec["batches"].append(batch)
                yield batch
        finally:
            stream.close()

    def hook(state, step):
        rec["step"] = step
        if step == 1:
            rec["g1"] = leaf_norms(state.optimizer.mu) / (1.0 - B1)
        if step == steps_checked:
            params = dict(state.model.named_parameters())
            rec["change"] = leaf_norms([params[n].detach() - w[n]
                                        for n in names])
        if step == t["warmup_steps"]:
            sync()
            sp.events.clear()
            rec["t_start"] = spans_mod.host_clock()
            rec["step_start"] = step
            env.mark_window_start()
            return
        if step < t["warmup_steps"]:
            return
        elapsed = spans_mod.host_clock() - rec["t_start"]
        if elapsed >= env.seconds:
            sync()
            rec["t_end"] = spans_mod.host_clock()
            rec["steps"] = step - rec["step_start"]
            raise _WindowClosed
        if prof is not None and not ranges.active and \
                elapsed >= env.seconds - t["profile_s"]:
            prof.start()
            ranges.active = True
            rec["prof_step"] = step

    loop.init_params = init_params
    loop.make_train_step = make_train_step
    loop.infinite_batches = infinite_batches
    if env.trace:
        pfusion.fused_fusion = ranges.wrap(saved[3], "fusion_fwd", _fwd_bytes)
        pops.fused_fusion_bwd = ranges.wrap(saved[4], "fusion_bwd",
                                            _bwd_bytes)
    profile = None
    try:
        with tempfile.TemporaryDirectory() as workdir:
            try:
                loop.train(cfg, pool, workdir, device=env.device,
                           gt_db=gt_db, num_steps=10 ** 9, eval_hook=hook,
                           eval_every=1)
            except _WindowClosed:
                pass
        if prof is not None and ranges.active:
            prof.stop()
            ranges.active = False
            profile = prof.reduce()
            profile["frames"] = (rec["step"] - rec["prof_step"]) * t["batch"]
        device_ms = sp.device_ms() if env.trace else {}
        memory_peak = (torch.cuda.max_memory_allocated(env.device)
                       if env.device.type == "cuda" else 0)
    finally:
        (loop.init_params, loop.make_train_step, loop.infinite_batches,
         pfusion.fused_fusion, pops.fused_fusion_bwd) = saved
        sp.close()
        rec.pop("model", None)
    losses = [float(x) for x in rec["losses"]]
    num_pos = [float(x) for x in rec["num_pos"]]
    gc.collect()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    window_s = rec["t_end"] - rec["t_start"]
    frames = rec["steps"] * t["batch"]
    return {"e2e": {"train_frames_per_s": frames / window_s},
            "attempted": rec["steps"], "failed": 0, "window_s": window_s,
            "memory_peak": memory_peak,
            "spans": {"device_ms": device_ms, "host_s": dict(sp.host),
                      "steps": rec["steps"], "frames": frames},
            "profile": profile, "ranges": ranges,
            "losses": losses, "num_pos": num_pos, "g1": rec["g1"],
            "change": rec["change"], "maps1": joined_maps(rec["maps1"]),
            "batches": rec["batches"], "pool_ref": pool_ref, "weights": w,
            "ref_cfg": ref_cfg}


def replay_batches(ref_cfg, pool_ref, n_steps: int) -> List[Dict]:
    """The loader's first `n_steps` batches worked out again with the
    reference's augmentation and preprocessing (`dcf_torch.data.loader`'s
    rule): epoch e's order shuffled by `default_rng(seed + e)`, whole
    batches only, example `i` drawn from `default_rng([seed, e, i])`."""
    seed, B = ref_cfg.train.seed, ref_cfg.train.batch_size
    db = ref_aug.GTDatabase.build(pool_ref)
    plan = []
    epoch = 0
    while len(plan) < n_steps:
        order = np.arange(len(pool_ref))
        np.random.default_rng(seed + epoch).shuffle(order)
        plan += [(epoch, order[s:s + B])
                 for s in range(0, len(order) - B + 1, B)]
        epoch += 1
    out = []
    for epoch, idx in plan[:n_steps]:
        exs = []
        for i in idx:
            rng = np.random.default_rng([seed, epoch, int(i)])
            frame = ref_aug.augment_frame(
                pool_ref[int(i)], ref_cfg.augment, rng, db=db,
                lidar_only_augs=not ref_cfg.with_fusion)
            exs.append(ref_pre.frame_to_example(
                frame, ref_cfg, seed=int(rng.integers(2 ** 31))))
        out.append(exs)
    return out


def reference_steps(ref_cfg, weights, batches, device, quant: str = "off"
                    ) -> Dict:
    """The reference's first steps in float32 (TF32 off), or with its
    convs rounded through float8 (`quant="fp8"`, the control): losses,
    the first step's head maps, per-leaf norms of the first clipped
    gradient and of the parameters' change after the last step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(ref_cfg, backbone=dataclasses.replace(
        ref_cfg.backbone, dtype="float32", quant_mode=quant))
    with torch.device(device):
        model = ref_detector.ContFuseDetector(cfg)
    weights_mod.load(model, weights)
    opt = ref_state.make_optimizer(cfg, model)
    pack = ref_anchors.anchor_pack(cfg, device)
    losses, num_pos, g1, maps1 = [], [], None, []
    handle = capture_maps(model, maps1)
    for exs in batches:
        tens = [{k: torch.from_numpy(np.ascontiguousarray(v[None])).to(
            device) for k, v in ex.items()} for ex in exs]
        _, metrics = ref_step.train_step(cfg, model, opt, tens, pack)
        losses.append(float(metrics["loss"]))
        num_pos.append(float(metrics["num_pos"]))
        if g1 is None:
            g1 = leaf_norms(opt.mu) / (1.0 - B1)
            handle.remove()
    params = dict(model.named_parameters())
    change = leaf_norms([params[n].detach() - weights[n] for n in weights])
    return {"losses": losses, "num_pos": num_pos, "g1": g1,
            "change": change, "maps1": joined_maps(maps1)}


def leaf_gap(prog: np.ndarray, ref: np.ndarray, ref_grad: np.ndarray
             ) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf; leaves whose reference gradient is under a
    thousandth of the median leaf's are left out (they move by
    round-off alone)."""
    keep = ref_grad >= 1e-3 * np.median(ref_grad)
    scale = np.maximum(ref, np.median(ref))
    return float(np.max(np.abs(prog - ref)[keep] / scale[keep]))


def fwd_err(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
            ) -> float:
    """The first step's worst head map: its RMS error over the
    reference's standard deviation (`serve.rel_err`); 1, an error as wide
    as the map itself, where the step saw other frames than the
    reference's batch."""
    if any(prog[k].shape != v.shape for k, v in ref.items()):
        return 1.0
    return max(rel_err(prog[k], v) for k, v in ref.items())


def compare_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """pos_diff: positive anchors over the steps that differ (exact);
    fwd_err: `fwd_err` of the first step's head maps; change_gap:
    `leaf_gap` of the parameters' change. Read and not compared, since
    neither has an upper reading (PERF.md): loss_gap, the first step's
    relative loss gap, and grad_gap, the first gradient's gap by the
    median leaf."""
    lp, lr = prog["losses"][0], ref["losses"][0]
    g_p, g_r = np.asarray(prog["g1"]), np.asarray(ref["g1"])
    keep = g_r >= 1e-3 * np.median(g_r)
    scale = np.maximum(g_r, np.median(g_r))
    return {"pos_diff": float(np.abs(np.asarray(prog["num_pos"])
                                     - np.asarray(ref["num_pos"])).sum()),
            "fwd_err": fwd_err(prog["maps1"], ref["maps1"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], g_r),
            "loss_gap": abs(lp - lr) / abs(lr),
            "grad_gap": float(np.median((np.abs(g_p - g_r) / scale)[keep]))}


def compare(run_out: Dict, device) -> Dict[str, float]:
    """The numbers compared: batch_diff (elements of the loader's first
    batches that differ from the reference's replay) and
    `compare_numbers` of the program's first steps against the
    reference's."""
    n = len(run_out["losses"])
    want = replay_batches(run_out["ref_cfg"], run_out["pool_ref"], n)
    diff = 0
    for got, exs in zip(run_out["batches"], want):
        for k in exs[0]:
            v = np.stack([e[k] for e in exs])
            g = got.get(k)
            diff += (v.size if g is None or g.shape != v.shape
                     or g.dtype != v.dtype else int((g != v).sum()))
    ref = reference_steps(run_out["ref_cfg"], run_out["weights"], want,
                          device)
    run_out["reference"], run_out["replayed"] = ref, want
    out = {"batch_diff": float(diff)}
    out.update(compare_numbers(run_out, ref))
    return out
