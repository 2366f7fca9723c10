"""The ContFuse family (`dcf_torch.models.detector.ContFuseDetector`, with
or without the image and the fusion layers): the program's serving path
and training loop, their spans and op ranges, the comparison with the
plain reference in `perfbench/reference/`, and the model FLOPs.

Serving: `frame_to_example` -> `stack_examples` ->
`make_inference_fn(cfg, model)(batch)` -> `to_host`. Training:
`dcf_torch.train.loop.train` itself with its augmenting loader; the
weights come from the benchmark (`loop.init_params` returns them), the
loop's seed from the run's seed.
"""

from __future__ import annotations

import dataclasses
import tempfile
from typing import Dict, List

import numpy as np
import torch

from perfbench import weights as weights_mod
from perfbench.reference import config as ref_config
from perfbench.reference.data import augment as ref_aug
from perfbench.reference.data import preprocess as ref_pre
from perfbench.reference.data.preprocess import image_stride_for
from perfbench.reference.models import anchors as ref_anchors
from perfbench.reference.models import detector as ref_detector
from perfbench.reference.models import head as ref_head
from perfbench.reference.train import state as ref_state
from perfbench.reference.train import step as ref_step

B1 = 0.9          # AdamW's first-moment decay (`dcf_torch.train.state`)


def reference_config(config_json: str):
    return ref_config.Config.from_json(config_json)


def leaf_init(module, leaf: str, name: str, shape):
    """`dcf_torch.params.init_params`'s rules (commit fab139f): lecun-normal
    convs, dense layers and the fusion layers' `geo_kernel` (fan-in 4) and
    `out_kernel`; GroupNorm scale 1; the class-logit bias at the 0.01
    prior; every other leaf 0."""
    fan = weights_mod.dense_fan_in(module, leaf, shape)
    if leaf == "geo_kernel":
        fan = 4
    elif leaf == "out_kernel":
        fan = shape[0]
    if fan:
        return "normal", fan
    if name.endswith("GroupNorm_0.weight"):
        return "const", 1.0
    if name == "head.cls.bias":
        return "const", weights_mod.PRIOR_BIAS
    return "const", 0.0


def make_weights(ref_cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """The run's weights, in the order of the reference model's
    parameters (built on the meta device)."""
    with torch.device("meta"):
        meta = ref_detector.ContFuseDetector(ref_cfg)
    return weights_mod.make_weights(meta, seed, device, leaf_init)


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


class _Patches:
    """Module attributes replaced for a run, restored by `close`."""

    def __init__(self):
        self._saved = []

    def patch(self, module, name: str, value) -> None:
        self._saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    def close(self) -> None:
        while self._saved:
            module, name, value = self._saved.pop()
            setattr(module, name, value)


# --- serving ------------------------------------------------------------


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


class Serving(_Patches):
    """The program's model with the run's weights and its inference
    function; a patch on `flatten_predictions` keeps the head maps of the
    frames the comparison reads."""

    def __init__(self, env, pool_ref):
        super().__init__()
        import dcf_torch.eval.inference as inference
        from dcf_torch.config import Config
        from dcf_torch.models.detector import ContFuseDetector
        self.inference = inference
        self.cfg = Config.from_json(env.config_json)
        self.ref_cfg = reference_config(env.config_json)
        self.roi = self.ref_cfg.voxel
        self.frames = [program_frame(f) for f in pool_ref]
        self.weights = make_weights(self.ref_cfg, env.seed, env.device)
        with torch.device(env.device):
            self.model = ContFuseDetector(self.cfg)
        weights_mod.load(self.model, self.weights)
        self._infer = inference.make_inference_fn(self.cfg, self.model,
                                                  env.device)
        self.capture = False
        self._maps = None
        flatten = inference.flatten_predictions

        def flatten_capture(preds, c):
            if self.capture:
                self._maps = preds
            return flatten(preds, c)
        self.patch(inference, "flatten_predictions", flatten_capture)
        if env.fault is not None:
            # the fault replaces decode_and_nms; close() restores it
            self.patch(inference, "decode_and_nms", inference.decode_and_nms)
            env.fault(inference)

    def prepare(self, frame):
        from dcf_torch.data.preprocess import frame_to_example, stack_examples
        ex = frame_to_example(frame, self.cfg)
        return ex, stack_examples([ex])

    def infer(self, batch):
        return self.inference.to_host(self._infer(batch))

    def take_maps(self) -> Dict[str, torch.Tensor]:
        maps, self._maps = self._maps, None
        return {k: v.detach() for k, v in maps.items()}

    def trace(self, sp, ranges) -> None:
        import dcf_torch.models.fusion as pfusion
        import dcf_torch.models.head as phead
        inference = self.inference
        sp.module(self.model, "forward")
        if self.cfg.with_camera:
            sp.module(self.model.image_backbone, "image_backbone")
        for name, child in self.model.named_children():
            if name.startswith("fusion_s"):
                sp.module(child, "fusion")
        self.patch(inference, "decode_and_nms",
                   sp.wrap(inference.decode_and_nms, "decode_nms"))
        self.patch(pfusion, "fused_fusion", ranges.wrap(
            pfusion.fused_fusion, "fusion_fwd", _fusion_bytes))
        self.patch(phead, "rotated_intersection_area_pairs", ranges.wrap(
            phead.rotated_intersection_area_pairs, "clip", _clip_bytes))

    def close(self) -> None:
        super().close()
        self.model = self._infer = None


def rel_err(p: torch.Tensor, r: torch.Tensor) -> float:
    """RMS of the difference over the reference's standard deviation."""
    p, r = p.to(torch.float64), r.to(torch.float64)
    return float((p - r).pow(2).mean().sqrt() / r.std().clamp(min=1e-30))


def _reference_model(cfg, weights, device, quant: str = "off"):
    """The float32 reference detector (TF32 off), or with its convs
    rounded through float8 (`quant="fp8"`), holding the run's weights."""
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="float32", quant_mode=quant))
    with torch.device(device):
        model = ref_detector.ContFuseDetector(cfg)
    weights_mod.load(model, weights)
    return model.eval(), cfg


def serve_compare(run_out: Dict, device, control: bool = False
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


# --- training -----------------------------------------------------------


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


class Training(_Patches):
    """`dcf_torch.train.loop.train` over the pool, with the run's batch,
    seed and weights; keeps the loader's first `check_steps` batches, the
    losses and positives of those steps, step 1's head maps, the first
    gradient's leaf norms (from AdamW's first moment after step 1) and
    the parameters' change after step `check_steps`."""

    def __init__(self, env, pool_ref):
        super().__init__()
        from dcf_torch.config import Config
        from dcf_torch.data.augment import GTDatabase
        t = env.traffic
        cfg = Config.from_json(env.config_json)
        self.cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=t["batch"], seed=env.seed))
        ref_cfg = reference_config(env.config_json)
        self.ref_cfg = dataclasses.replace(ref_cfg, train=dataclasses.replace(
            ref_cfg.train, batch_size=t["batch"], seed=env.seed))
        self.env = env
        self.pool_ref = pool_ref
        self.pool = [program_frame(f) for f in pool_ref]
        self.gt_db = GTDatabase.build(self.pool)
        self.weights = make_weights(self.ref_cfg, env.seed, env.device)
        self.check_steps = t["check_steps"]
        self.rec = {"losses": [], "num_pos": [], "batches": [], "maps1": []}

    def trace(self, ranges) -> None:
        import dcf_torch.models.fusion as pfusion
        import dcf_torch.ops.fusion as pops
        self.patch(pfusion, "fused_fusion", ranges.wrap(
            pfusion.fused_fusion, "fusion_fwd", _fwd_bytes))
        self.patch(pops, "fused_fusion_bwd", ranges.wrap(
            pops.fused_fusion_bwd, "fusion_bwd", _bwd_bytes))

    def run(self, on_step, wrap_batches, wrap_step) -> None:
        import dcf_torch.train.loop as loop
        from dcf_torch.models.detector import ContFuseDetector
        rec, w, n = self.rec, self.weights, self.check_steps
        names = list(w)
        init_params, make_train_step = loop.init_params, loop.make_train_step
        infinite_batches = loop.infinite_batches

        def build(c, _generator, device="cuda"):
            with torch.device(device):
                model = ContFuseDetector(c)
            model = weights_mod.load(model, w).eval()
            rec["model"] = model
            return model

        def step_fn(c, model, device, debug=False):
            timed = wrap_step(make_train_step(c, model, device, debug=debug))

            def wrapped(state, batch, pack):
                if rec["losses"]:
                    state, metrics = timed(state, batch, pack)
                else:                       # step 1: keep its head maps
                    handle = capture_maps(rec["model"], rec["maps1"])
                    try:
                        state, metrics = timed(state, batch, pack)
                    finally:
                        handle.remove()
                if len(rec["losses"]) < n:
                    rec["losses"].append(metrics["loss"].detach().clone())
                    rec["num_pos"].append(
                        metrics["num_pos"].detach().clone())
                return state, metrics
            return wrapped

        def batches(loader):
            stream = wrap_batches(infinite_batches(loader))
            try:
                while True:
                    batch = next(stream)
                    if len(rec["batches"]) < n:
                        rec["batches"].append(batch)
                    yield batch
            finally:
                stream.close()

        def hook(state, step):
            if step == 1:
                rec["g1"] = leaf_norms(state.optimizer.mu) / (1.0 - B1)
            if step == n:
                params = dict(state.model.named_parameters())
                rec["change"] = leaf_norms([params[k].detach() - w[k]
                                            for k in names])
            on_step(step)

        self.patch(loop, "init_params", build)
        self.patch(loop, "make_train_step", step_fn)
        self.patch(loop, "infinite_batches", batches)
        try:
            with tempfile.TemporaryDirectory() as workdir:
                loop.train(self.cfg, self.pool, workdir,
                           device=self.env.device, gt_db=self.gt_db,
                           num_steps=10 ** 9, eval_hook=hook, eval_every=1)
        finally:
            rec.pop("model", None)

    def outputs(self) -> Dict:
        rec = self.rec
        return {"losses": [float(x) for x in rec["losses"]],
                "num_pos": [float(x) for x in rec["num_pos"]],
                "g1": rec["g1"], "change": rec["change"],
                "maps1": joined_maps(rec["maps1"]),
                "batches": rec["batches"], "pool_ref": self.pool_ref,
                "weights": self.weights, "ref_cfg": self.ref_cfg}


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
    reference's standard deviation (`rel_err`); 1, an error as wide as the
    map itself, where the step saw other frames than the reference's
    batch."""
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


def train_compare(run_out: Dict, device) -> Dict[str, float]:
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


def compare(mode: str, run_out: Dict, device) -> Dict[str, float]:
    """The numbers of `correct`, by mode."""
    if mode == "serve":
        return serve_compare(run_out, device)
    return train_compare(run_out, device)


# --- readings (perfbench/readings.py) -------------------------------------


def _worst_leaves(prog, ref, names, n=3):
    """The leaves with the widest gaps, for the look at a reading."""
    out = {}
    for key in ("g1", "change"):
        p, r = np.asarray(prog[key]), np.asarray(ref[key])
        scale = np.maximum(r, np.median(r))
        keep = ref["g1"] >= 1e-3 * np.median(ref["g1"])
        gap = np.where(keep, np.abs(p - r) / scale, 0.0)
        out[key + "_worst"] = [[names[i], float(p[i]), float(r[i]),
                                float(gap[i])]
                               for i in np.argsort(-gap)[:n]]
    out["losses"] = [list(map(float, prog["losses"])),
                     list(map(float, ref["losses"]))]
    return out


def control(mode: str, run_out: Dict, device) -> Dict:
    """The control's numbers on the run's own frames or batches: the
    reference with its convs rounded through float8 in the program's
    place (after the run's own comparison)."""
    if mode == "serve":
        return serve_compare(run_out, device, control=True)
    low = reference_steps(run_out["ref_cfg"], run_out["weights"],
                          run_out["replayed"], device, quant="fp8")
    numbers = {"batch_diff": 0.0}
    numbers.update(compare_numbers(low, run_out["reference"]))
    numbers.update(_worst_leaves(low, run_out["reference"],
                                 list(run_out["weights"])))
    return numbers


def look(mode: str, run_out: Dict) -> Dict:
    """Beside a training run's numbers, its worst leaves and losses."""
    if mode != "train":
        return {}
    return _worst_leaves(run_out, run_out["reference"],
                         list(run_out["weights"]))


# --- model FLOPs --------------------------------------------------------
#
# A frozen copy of `dcf_torch/utils/flops.py` (commit fab139f), reading the
# reference's copy of the configuration, so that the yardstick does not
# move with the program. Model FLOPs only (the useful math): a matmul or
# conv counts 2 * M * N * K; norms, activations and elementwise work are
# ignored (<1% of a conv stack); the voxelize scatter, gathers and NMS
# count 0; the fusion kernel's one-hot selection and the KNN cascade are
# implementation, not model math, and depress `mfu` as they should.


def _conv_flops(h: int, w: int, cin: int, cout: int, k: int) -> int:
    """2*H*W*Cin*Cout*k*k at the OUTPUT resolution (h, w)."""
    return 2 * h * w * cin * cout * k * k


def _basic_block_flops(h: int, w: int, cin: int, cout: int,
                       stride: int) -> int:
    """dcf_torch.models.layers.BasicBlock at output resolution (h, w)."""
    f = _conv_flops(h, w, cin, cout, 3) + _conv_flops(h, w, cout, cout, 3)
    if cin != cout or stride != 1:
        f += _conv_flops(h, w, cin, cout, 1)      # projection shortcut
    return f


def image_backbone_flops(cfg) -> int:
    """dcf_torch.models.resnet.ImageBackbone forward FLOPs for one image."""
    bb = cfg.backbone
    h, w = cfg.image.height, cfg.image.width
    # patchify stem: s2d(4) + 1x1 ConvNorm == 4x4 stride-4 conv
    h, w = h // 4, w // 4
    total = _conv_flops(h, w, 16 * cfg.image.channels,
                        bb.image_stage_channels[0], 1)
    cin = bb.image_stage_channels[0]
    for stage, cout in enumerate(bb.image_stage_channels):
        first_stride = 1 if stage == 0 else 2
        if first_stride == 2:
            h, w = h // 2, w // 2
        total += _basic_block_flops(h, w, cin, cout, first_stride)
        for _ in range(bb.image_blocks_per_stage[stage] - 1):
            total += _basic_block_flops(h, w, cout, cout, 1)
        cin = cout
    return total


def bev_backbone_flops(cfg) -> int:
    """BEV encoder stages (dcf_torch.models.detector) for one frame."""
    bb = cfg.backbone
    h, w = cfg.voxel.grid_x, cfg.voxel.grid_y
    cin = cfg.voxel.bev_channels
    total = 0
    for stage, cout in enumerate(bb.bev_stage_channels):
        h, w = h // 2, w // 2                      # every stage strides 2
        if stage == 0:
            # s2d raster in: kernel-2/stride-1 entry conv on 4*cin
            # channels + 1x1 projection shortcut (dcf_torch.models.detector)
            total += (_conv_flops(h, w, 4 * cin, cout, 2)
                      + _conv_flops(h, w, cout, cout, 3)
                      + _conv_flops(h, w, 4 * cin, cout, 1))
        else:
            total += _basic_block_flops(h, w, cin, cout, 2)
        for _ in range(bb.bev_blocks_per_stage[stage] - 1):
            total += _basic_block_flops(h, w, cout, cout, 1)
        cin = cout
    return total


def fpn_flops(cfg) -> int:
    """dcf_torch.models.bev_backbone.BEVFPN for one frame."""
    bb = cfg.backbone
    H, W = cfg.voxel.grid_x, cfg.voxel.grid_y
    strides = [2 ** (i + 1) for i in range(len(bb.bev_stage_channels))]
    top = max(strides)
    total = _conv_flops(H // top, W // top, bb.bev_stage_channels[-1],
                        bb.fpn_channels, 1)
    stride = top
    while stride > bb.head_stride:
        stride //= 2
        idx = strides.index(stride)
        total += _conv_flops(H // stride, W // stride,
                             bb.bev_stage_channels[idx], bb.fpn_channels, 1)
    hh, ww = H // bb.head_stride, W // bb.head_stride
    total += _conv_flops(hh, ww, bb.fpn_channels, bb.fpn_channels, 3)
    return total


def head_flops(cfg) -> int:
    """dcf_torch.models.head.DetectionHead for one frame."""
    bb = cfg.backbone
    h = cfg.voxel.grid_x // bb.head_stride
    w = cfg.voxel.grid_y // bb.head_stride
    A = cfg.anchors_per_loc
    total = 0
    cin = bb.fpn_channels
    for _ in range(cfg.head.num_convs):
        total += _conv_flops(h, w, cin, cfg.head.head_channels, 3)
        cin = cfg.head.head_channels
    out_ch = A + A * 7 + (A * 2 if cfg.head.use_direction_classifier else 0)
    total += _conv_flops(h, w, cin, out_ch, 1)
    return total


def fusion_flops(cfg) -> int:
    """Continuous-fusion layers (dcf_torch.models.fusion) for one frame:
    per-point image-half Dense + bilinear lerp, per (pixel, neighbour)
    geometric half + add + relu, masked K-sum, and the output layer."""
    if not cfg.with_fusion:
        return 0
    fus = cfg.fusion
    bb = cfg.backbone
    P = cfg.voxel.max_points
    hid = fus.hidden_dim
    K = fus.num_neighbors
    total = 0
    for s in bb.fusion_strides:
        img_stride = image_stride_for(s)
        img_idx = {4: 0, 8: 1, 16: 2, 32: 3}[img_stride]
        c_img = bb.image_stage_channels[img_idx]
        H = cfg.voxel.grid_x // s
        W = cfg.voxel.grid_y // s
        total += 8 * P * c_img                  # bilinear: 4 taps x lerp
        total += 2 * P * c_img * hid            # img_proj Dense
        per_pair = 2 * 4 * hid + 2 * hid        # geo half + add + K-sum
        total += H * W * K * per_pair
        stage_strides = [2 ** (i + 1)
                         for i in range(len(bb.bev_stage_channels))]
        out_ch = bb.bev_stage_channels[stage_strides.index(s)]
        total += 2 * H * W * hid * out_ch       # output layer
    return total


def inference_flops_per_frame(cfg) -> Dict[str, int]:
    """Analytic model FLOPs for one end-to-end inference frame."""
    parts = {
        "bev_backbone": bev_backbone_flops(cfg),
        "fpn": fpn_flops(cfg),
        "head": head_flops(cfg),
    }
    if cfg.with_camera:
        parts["image_backbone"] = image_backbone_flops(cfg)
    if cfg.with_fusion:
        parts["fusion"] = fusion_flops(cfg)
    parts["total"] = sum(parts.values())
    return parts


def flops_per_frame(cfg, mode: str) -> int:
    """A served frame's model FLOPs, or a trained frame's: forward and
    backward ~ 3x forward (the backward computes the gradients of both
    the inputs and the weights)."""
    total = inference_flops_per_frame(cfg)["total"]
    return total if mode == "serve" else 3 * total
