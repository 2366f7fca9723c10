"""The PointPillars family (`dcf_torch.models.pointpillars.
PointPillarsDetector`): the program's serving path, its spans and op
ranges, the comparison with the plain reference in
`perfbench/reference_pointpillars/`, the model FLOPs and the bytes of the
pillar encoder's two kernels.

Serving: `pillar_example` (the host crop) -> `stack_examples` ->
`make_inference_fn(cfg, model)(batch)` -> `to_host`. The family serves
only: no training cell names it, and the program cannot train it yet.

Weights: convs, transposed convs and the PFN's linear layer He-normal
(each feeds a ReLU), the head's 1x1 convs lecun-normal with the class
prior, all through `weights.make_weights`; then, from a second generator
seeded with the seed, BatchNorm scales in [0.5, 1.5) and shifts of
standard deviation 0.2, and running statistics taken from the reference
on the pool's first frame (each layer's batch statistics, in training
mode) and moved off them: the mean by 0.1 standard deviations at random,
the variance by a factor in [0.7, 1.42). So every layer's statistics are
far from 0 / 1, as a trained network's are, and a mistake in folding or
applying them shows.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from perfbench import reference_pointpillars as ref
from perfbench import weights as weights_mod
from perfbench.families.contfuse import (_clip_bytes, _dets_diff, _Patches,
                                        program_frame, rel_err)
from perfbench.reference.models import anchors as ref_anchors
from perfbench.reference.models import head as ref_head


def reference_config(config_json: str) -> ref.Spec:
    return ref.Spec.from_json(config_json)


def leaf_init(module, leaf: str, name: str, shape):
    if isinstance(module, nn.ConvTranspose2d) and leaf == "weight":
        return "normal", shape[0] / 2        # kernel = stride: one tap
    fan = weights_mod.dense_fan_in(module, leaf, shape)
    if fan:
        return "normal", fan if name.startswith("head.") else fan / 2
    if name == "head.cls.bias":
        return "const", weights_mod.PRIOR_BIAS
    return "const", 0.0                      # BatchNorm's: drawn below


def _norms(model: nn.Module):
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)]


def state_names(model: nn.Module):
    """What the weights hold: the parameters and the BatchNorm running
    statistics."""
    return [n for n, _ in model.named_parameters()] + [
        n for n, _ in model.named_buffers()
        if not n.endswith("num_batches_tracked")]


def load(model: nn.Module, weights: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy `weights` into `model`'s parameters and running statistics;
    raises unless they name exactly those."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    names = state_names(model)
    if set(names) != set(weights):
        raise ValueError(f"weights: {sorted(set(names) ^ set(weights))[:5]}"
                         f" differ between the model and the weights")
    with torch.no_grad():
        for n in names:
            own[n].copy_(weights[n])
    return model


def make_weights(spec: ref.Spec, seed: int, device, frame
                 ) -> Dict[str, torch.Tensor]:
    """The run's weights (see the module's docstring); `frame` is the one
    the running statistics are taken on."""
    with torch.device("meta"):
        meta = ref.PointPillars(spec)
    w = weights_mod.make_weights(meta, seed, device, leaf_init)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    for name, m in _norms(meta):
        c = m.num_features
        w[name + ".weight"] = 0.5 + torch.rand(c, generator=g, device=device)
        w[name + ".bias"] = 0.2 * torch.randn(c, generator=g, device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(device):
        model = ref.PointPillars(spec)
    weights_mod.load(model, {n: w[n] for n, _ in model.named_parameters()})
    for _, m in _norms(model):
        m.momentum = 1.0                     # running := this batch's
    ex = ref.example(frame, spec)
    tables = ref.tables_to(ref.pillarize(ex["points"], ex["point_mask"],
                                         spec), device)
    with torch.no_grad():
        model.train()(torch.from_numpy(ex["points"]).to(device), tables)
    for name, m in _norms(model):
        sd = m.running_var.sqrt()
        w[name + ".running_mean"] = m.running_mean + 0.1 * sd * torch.randn(
            m.num_features, generator=g, device=device)
        w[name + ".running_var"] = m.running_var * torch.exp(
            0.7 * torch.rand(m.num_features, generator=g, device=device)
            - 0.35)
    return w


# --- serving ------------------------------------------------------------


def pillarize_bytes(a, out):
    """Bytes pillarization needs: the mask, the masked points (16 B),
    and every output whole (the tables and the stats)."""
    mask = a[1]
    return (mask.numel() + 16 * mask.sum()
            + sum(t.numel() * t.element_size() for t in out))


def pfn_bytes(a, out):
    """Bytes the PFN and its scatter need: each kept point once (16 B)
    with its slot's index (4 B), each pillar's count, mask and coords,
    the folded weights, and the canvas rows of the kept pillars written
    once (not the [P, N, C] tensor a plain PFN makes)."""
    _points, pillars, weight, bias, _vox, canvas = a[:6]
    P = pillars.mask.shape[1]
    st = pillars.stats.to(torch.int64)
    kept = st[:, 2].clamp(max=P).sum()
    return (20 * st[:, 1].sum() + 13 * pillars.counts.numel()
            + 4 * (weight.numel() + bias.numel())
            + kept * canvas.shape[-1] * canvas.element_size())


class Serving(_Patches):
    """The program's detector with the run's weights and its inference
    function; patches keep the head maps (on `flatten_predictions`) and
    the pillar tables (on `pillarize`) of the frames the comparison
    reads."""

    def __init__(self, env, pool_ref):
        super().__init__()
        import json
        import dcf_torch.eval.inference as inference
        from dcf_torch.models import pointpillars as ppm
        self.inference, self.ppm = inference, ppm
        self.cfg, self.pillar = ppm.from_dict(json.loads(env.config_json))
        self.ref_cfg = reference_config(env.config_json)
        self.roi = self.ref_cfg.voxel
        self.frames = [program_frame(f) for f in pool_ref]
        self.weights = make_weights(self.ref_cfg, env.seed, env.device,
                                    pool_ref[0])
        with torch.device(env.device):
            self.model = ppm.PointPillarsDetector(self.cfg, self.pillar)
        load(self.model, self.weights)
        self._infer = inference.make_inference_fn(self.cfg, self.model,
                                                  env.device)
        self.capture = False
        self._maps = self._tables = None
        flatten, pillarize = inference.flatten_predictions, ppm.pillarize

        def flatten_capture(preds, c):
            if self.capture:
                self._maps = dict(preds, pillars=self._tables)
            return flatten(preds, c)

        def pillarize_capture(*a, **k):
            out = pillarize(*a, **k)
            if self.capture:
                self._tables = {f: getattr(out, f)[0] for f in out._fields}
            return out
        self.patch(inference, "flatten_predictions", flatten_capture)
        self.patch(ppm, "pillarize", pillarize_capture)
        if env.fault is not None:
            # the fault replaces decode_and_nms; close() restores it
            self.patch(inference, "decode_and_nms", inference.decode_and_nms)
            env.fault(inference)

    def prepare(self, frame):
        from dcf_torch.data.preprocess import stack_examples
        ex = self.ppm.pillar_example(frame, self.cfg)
        return ex, stack_examples([ex])

    def infer(self, batch):
        return self.inference.to_host(self._infer(batch))

    def take_maps(self) -> Dict:
        maps, self._maps = self._maps, None
        return {k: v if k == "pillars" else v.detach()
                for k, v in maps.items()}

    def trace(self, sp, ranges) -> None:
        import dcf_torch.models.head as phead
        inference, ppm = self.inference, self.ppm
        sp.module(self.model, "forward")
        sp.module(self.model.pfn, "pillar")
        sp.module(self.model.backbone, "pp_backbone")
        self.patch(inference, "decode_and_nms",
                   sp.wrap(inference.decode_and_nms, "decode_nms"))
        self.patch(ppm, "pillarize", ranges.wrap(
            ppm.pillarize, "pillarize", pillarize_bytes))
        self.patch(ppm, "pfn_scatter", ranges.wrap(
            ppm.pfn_scatter, "pfn", pfn_bytes))
        self.patch(phead, "rotated_intersection_area_pairs", ranges.wrap(
            phead.rotated_intersection_area_pairs, "clip", _clip_bytes))

    def close(self) -> None:
        super().close()
        self.model = self._infer = None


class Training:
    def __init__(self, env, pool_ref):
        raise ValueError("the pointpillars family serves only: the program "
                         "cannot train PointPillars yet")


def _reference_model(spec, weights, device, quant: str = "off"):
    with torch.device(device):
        model = ref.PointPillars(spec, quant)
    return load(model, weights).eval()


def _elements_differ(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
                     ) -> int:
    out = 0
    for k, v in want.items():
        g = np.asarray(got[k])
        out += (v.size if g.shape != v.shape or g.dtype != v.dtype
                else int((g != v).sum()))
    return out


def serve_compare(run_out: Dict, device, control: bool = False
                  ) -> Dict[str, float]:
    """The numbers compared with the reference, over the checked frames:
      pillar_diff  elements of the program's example (the cropped points
                   and mask) and pillar tables (coords, counts, mask, slot
                   table, stats) that differ from the reference's crop
                   and its loop over the points;
      head_err     the worst head map's RMS error against the float32
                   reference forward (TF32 off) on the reference's own
                   example and tables, over the map's standard deviation;
      dets_diff    detection slots that differ from the reference's
                   decode and NMS of the program's own head maps.
    With `control`, the reference with its backbone's convs rounded
    through float8 takes the program's place: its head maps are judged
    (pillar_diff and dets_diff are then 0 by construction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec, weights = run_out["ref_cfg"], run_out["weights"]
    model = _reference_model(spec, weights, device)
    low = (_reference_model(spec, weights, device, "fp8") if control
           else None)
    anchors, classes, _, _ = ref_anchors.generate_anchors(spec.detector)
    anchors = torch.from_numpy(anchors).to(device)
    classes = torch.from_numpy(classes).to(device)
    pillar_diff, head_err, dets_diff = 0, 0.0, 0
    with torch.no_grad():
        for j, cap in sorted(run_out["captured"].items()):
            ex = ref.example(run_out["pool_ref"][j], spec)
            tables = ref.pillarize(ex["points"], ex["point_mask"], spec)
            points = torch.from_numpy(ex["points"]).to(device)
            t = ref.tables_to(tables, device)
            maps = model(points, t)
            if low is not None:
                got = low(points, t)
                for k, v in maps.items():
                    head_err = max(head_err, rel_err(got[k], v))
                continue
            got = {k: v.cpu().numpy()
                   for k, v in cap["maps"]["pillars"].items()}
            pillar_diff += (_elements_differ(cap["example"], ex)
                            + _elements_differ(got, tables))
            for k, v in maps.items():
                head_err = max(head_err, rel_err(cap["maps"][k], v))
            flat = ref_head.flatten_predictions(
                {k: cap["maps"][k].to(torch.float32) for k in maps},
                spec.detector)
            want = ref_head.decode_and_nms(flat, anchors, classes,
                                           spec.detector)
            dets_diff += _dets_diff(cap["dets"], want)
    return {"pillar_diff": float(pillar_diff), "head_err": head_err,
            "dets_diff": float(dets_diff)}


def compare(mode: str, run_out: Dict, device) -> Dict[str, float]:
    """The numbers of `correct` (serving only)."""
    if mode != "serve":
        raise ValueError("the pointpillars family serves only")
    return serve_compare(run_out, device)


def control(mode: str, run_out: Dict, device) -> Dict:
    """The control's numbers on the run's own frames (readings.py)."""
    if mode != "serve":
        raise ValueError("the pointpillars family serves only")
    return serve_compare(run_out, device, control=True)


def look(mode: str, run_out: Dict) -> Dict:
    return {}


# --- model FLOPs --------------------------------------------------------


def inference_flops_per_frame(spec: ref.Spec) -> Dict[str, int]:
    """Model FLOPs of one served frame (2 * M * N * K for every linear
    layer, conv and transposed conv; norms, activations, the scatter,
    decode and NMS count 0). The PFN counts its linear layer on the dense
    P x N slots, as the network is defined."""
    vox, pc, det = spec.voxel, spec.pillar, spec.detector
    H, W = vox.grid_x, vox.grid_y
    parts = {"pfn": 2 * pc.max_pillars * pc.max_points * ref.NUM_FEATURES
             * pc.features}
    h, w, cin, blocks, maps = H, W, pc.features, 0, []
    for layers, c in zip(pc.block_layers, pc.block_channels):
        h, w = h // 2, w // 2
        blocks += 2 * h * w * 9 * (cin * c + (layers - 1) * c * c)
        maps.append(c)
        cin = c
    parts["blocks"] = blocks
    s = det.backbone.head_stride
    ho, wo = H // s, W // s
    # kernel = stride: each output pixel takes one tap of each input channel
    up = 2 * pc.features
    parts["upsample"] = sum(2 * ho * wo * c * up for c in maps)
    A = det.anchors_per_loc
    parts["head"] = (2 * ho * wo * up * len(pc.up_strides)
                     * (A + 7 * A + 2 * A))
    parts["total"] = sum(parts.values())
    return parts


def flops_per_frame(spec: ref.Spec, mode: str) -> int:
    """A served frame's model FLOPs (a trained frame's would be ~3x)."""
    total = inference_flops_per_frame(spec)["total"]
    return total if mode == "serve" else 3 * total

