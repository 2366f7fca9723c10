"""The port's training path against the JAX package's, on the CPU.

The JAX side runs as its own CPU tests run it (`tiny_config`, where
`resolve_platform` turns Pallas off: the jnp twins), jitted. Both sides
get the same numpy inputs: batches from the JAX package's host path, and
the port's seeded `init_params` carried to flax with `to_flax`.

Tolerances, each with its reason:
  - target assignment is integer / selection logic over float32 IoUs
    computed op for op alike: targets equal, `reg_target` (a log and
    divisions) within 1e-6; anchors whose IoU lies within 1e-6 of a
    threshold are counted and reported, not tolerated;
  - losses: float32 elementwise math with other summation orders:
    rtol 1e-5;
  - the full train step in float32 compute (gradient parity is held in
    float32: the JAX package's bf16 z1 table scatters d_z1 through a bf16
    gather transpose, where the port accumulates in float32): loss,
    metrics, the updated parameters and the EMA at the tolerances of
    tests/test_oracle_e2e.py (atol 2e-4 x max|want|, rtol 2e-3). Every
    gradient leaf: rtol 2e-3 and atol GRAD_ATOL = 1e-3 x max|want|, not
    2e-4: evaluated in float64 (the port with every float32 cast made
    float64), the same step's float32 gradients err by up to 3.7e-4 x
    max|want| in the JAX package and 4.8e-4 x max|want| in the port, on
    GroupNorm-bias leaves whose elements are sums with heavy
    cancellation and where a relu whose input lies within float32
    rounding of 0 goes one way in one package and the other way in the
    other; two packages that each err by up to 5e-4 can differ by 1e-3;
  - gradient accumulation against the full batch, as tests/test_train.py
    holds the JAX package's;
  - augmentation and batches are numpy in both packages: bit-equal, but
    the image, which inherits the resize's one uint8 level
    (tests/test_torch_host.py).

The relu tie at pre == 0 (jnp.maximum's gradient 0.5, the port's 0, as
the TPU kernel's) is a measure-zero event for these float32 inputs;
tests/test_torch_fusion_bwd.py counts it on its inputs.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dcf.config as jcfg
import dcf.data.augment as jaug
import dcf.data.loader as jload
import dcf.data.synthetic as jsyn
import dcf.train.losses as jlosses
import dcf.train.targets as jtargets
from dcf.data.preprocess import frame_to_example, stack_examples
from dcf.models.anchors import anchor_grid_shape
from dcf.models.detector import ContFuseDetector as JaxDetector
from dcf.train.state import create_train_state as jax_train_state
from dcf.train.state import make_optimizer as jax_optimizer
from dcf.train.step import build_loss_fn, make_train_step as jax_train_step
import dcf_torch.config as tcfg
import dcf_torch.data.augment as taug
import dcf_torch.data.loader as tload
import dcf_torch.data.synthetic as tsyn
import dcf_torch.train.losses as tlosses
import dcf_torch.train.targets as ttargets
from dcf_torch.eval.inference import batch_to_device
from dcf_torch.models.anchors import anchor_pack
from dcf_torch.models.detector import ContFuseDetector
from dcf_torch.params import grads_to_flax, init_params, load_flax, to_flax
from dcf_torch.train import checkpoint as tckpt
from dcf_torch.train.state import (AdamW, create_train_state, global_norm,
                                   lr_schedule)
from dcf_torch.train.step import make_train_step

torch.set_num_threads(1)

ORACLE_ATOL, ORACLE_RTOL = 2e-4, 2e-3     # x max|want|; test_oracle_e2e
GRAD_ATOL = 1e-3                          # x max|want|; see the docstring


def _f32(cfg, **train):
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="float32"),
        train=dataclasses.replace(cfg.train, **train))


def _batch(cfg, seeds):
    return stack_examples([frame_to_example(jsyn.make_varied_frame(seed=s),
                                            cfg) for s in seeds])


def _close(got, want, what, atol=ORACLE_ATOL, rtol=ORACLE_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


# ---------------------------------------------------------------- (b) targets

# tiny_config's anchor grid is 32 x 32 cells x 6 anchors (3 classes x 2
# rotations, class-major); this is cell (20, 30)'s first pedestrian one
TIE_ANCHOR = (20 * 32 + 30) * 6 + 2


def _assign_inputs():
    """Anchors of tiny_config and the gt of four seed-varied frames, plus
    a frame of hand-placed boxes: two identical gts on one anchor (the
    first gt must win), a box at the grid's edge, one labelled with
    another class than its shape."""
    cfg = jcfg.tiny_config(True)
    boxes, classes, m_thr, u_thr = anchor_pack_np(cfg)
    batch = _batch(cfg, range(4))
    gb, gl, gm = batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"]
    hand = np.zeros_like(gb[:1])
    hl = np.zeros_like(gl[:1])
    hm = np.zeros_like(gm[:1])
    a0 = boxes[TIE_ANCHOR]                        # a pedestrian anchor
    edge = boxes[-6]                              # the last cell's car
    hand[0, :4] = [a0, a0, edge, a0 + [1, 1, 0, 0, 0, 0, 0.3]]
    hl[0, :4] = [1, 1, 0, 2]
    hm[0, :4] = True
    return (cfg, (boxes, classes, m_thr, u_thr),
            (np.concatenate([gb, hand]), np.concatenate([gl, hl]),
             np.concatenate([gm, hm])))


def anchor_pack_np(cfg):
    from dcf.models.anchors import anchor_pack as jax_anchor_pack
    p = jax_anchor_pack(cfg)
    return p["boxes"], p["classes"], p["matched_thr"], p["unmatched_thr"]


@pytest.fixture(scope="module")
def assigned():
    cfg, pack, gt = _assign_inputs()
    grid = dict(grid_shape=anchor_grid_shape(cfg),
                grid_origin=(cfg.voxel.x_min, cfg.voxel.y_min),
                grid_cell=cfg.voxel.voxel_size * cfg.backbone.head_stride,
                window=cfg.train.assigner_window, per_class_anchors=2)
    jpack = [jnp.asarray(a) for a in pack]
    jgt = [jnp.asarray(a) for a in gt]
    want = jax.jit(functools.partial(jtargets.assign_targets_batch,
                                     **grid))(*jpack, *jgt)
    want_dense = jax.jit(jax.vmap(
        lambda b, l, m: jtargets.assign_targets_dense(*jpack, b, l, m)))(
            *jgt)
    tpack = [torch.from_numpy(a) for a in pack]
    tpack[1] = tpack[1].long()
    tgt = [torch.from_numpy(a) for a in gt]
    got = ttargets.assign_targets_batch(*tpack, *tgt, **grid)
    got_dense = ttargets.assign_targets_dense(*tpack, *tgt)
    near = _count_near_thresholds(pack, gt)
    print(f"anchors within 1e-6 of an IoU threshold: {near}")
    return cfg, pack, gt, near, (got, want), (got_dense, want_dense)


def _compare_targets(got, want):
    for name in ("cls_target", "cls_weight", "reg_weight", "dir_target",
                 "num_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(
        got.reg_target.numpy(),
        np.swapaxes(np.asarray(want.reg_target), 1, 2), rtol=0, atol=1e-6)


@pytest.mark.parametrize("variant", ["windowed", "dense"])
def test_assigner_matches_jax(assigned, variant):
    cfg, pack, gt, near, windowed, dense = assigned
    got, want = windowed if variant == "windowed" else dense
    assert near == 0
    _compare_targets(got, want)
    assert got.num_pos.sum() > 0


def _count_near_thresholds(pack, gt):
    """Anchors whose best same-class IoU lies within 1e-6 of their matched
    or unmatched threshold (dense, float64 clip of the port's plain
    version)."""
    boxes, classes, m_thr, u_thr = (torch.from_numpy(a).double()
                                    for a in pack)
    gb, gl, gm = (torch.from_numpy(a) for a in gt)
    from dcf_torch.geometry.boxes import rotated_iou_bev
    near = 0
    for b in range(gb.shape[0]):
        g = gb[b][gm[b]].double()
        if not len(g):
            continue
        iou = rotated_iou_bev(boxes[:, [0, 1, 3, 4, 6]], g[:, [0, 1, 3, 4, 6]])
        iou = torch.where(classes[:, None] == gl[b][gm[b]][None].double(),
                          iou, 0.0)
        best = iou.max(1).values
        near += int(((best - m_thr).abs() < 1e-6).sum()
                    + ((best - u_thr).abs() < 1e-6).sum())
    return near


def test_assigner_first_gt_wins_ties(assigned):
    """The two identical gts of the hand-placed frame claim one anchor
    with IoU 1: it is positive and matched to the first of them."""
    cfg, pack, gt, _, (got, _), _ = assigned
    b = gt[0].shape[0] - 1
    assert got.cls_target[b, TIE_ANCHOR] == 1
    np.testing.assert_allclose(got.reg_target[b, TIE_ANCHOR].numpy(), 0,
                               atol=1e-6)


def test_assign_targets_single_frame(assigned):
    """`assign_targets` (one frame, no batch dimension) is the batch's
    row for that frame."""
    cfg, pack, gt, _, (got, _), _ = assigned
    tpack = [torch.from_numpy(a) for a in pack]
    tpack[1] = tpack[1].long()
    one = ttargets.assign_targets(
        *tpack, *(torch.from_numpy(a[1]) for a in gt),
        grid_shape=anchor_grid_shape(cfg),
        grid_origin=(cfg.voxel.x_min, cfg.voxel.y_min),
        grid_cell=cfg.voxel.voxel_size * cfg.backbone.head_stride,
        window=cfg.train.assigner_window, per_class_anchors=2)
    for a, b in zip(one, got):
        assert torch.equal(a, b[1])


def test_assigner_one_clip_call(assigned, monkeypatch):
    """The windows of the whole batch go through ONE call of the clip
    wrapper (one launch of the clip kernel on the card)."""
    cfg, pack, gt = assigned[:3]
    calls = []
    real = ttargets.rotated_intersection_area_pairs

    def counting(a, b):
        calls.append(a.shape[0])
        return real(a, b)
    monkeypatch.setattr(ttargets, "rotated_intersection_area_pairs",
                        counting)
    tpack = [torch.from_numpy(a) for a in pack]
    tpack[1] = tpack[1].long()
    ttargets.assign_targets_batch(
        *tpack, *(torch.from_numpy(a) for a in gt),
        grid_shape=anchor_grid_shape(cfg), grid_origin=(0.0, -12.8),
        grid_cell=0.8, window=24, per_class_anchors=2)
    assert anchor_grid_shape(cfg) == (32, 32, 6)
    B, G = gt[2].shape
    assert calls == [B * G * 24 * 24 * 2]


# ----------------------------------------------------------------- (c) losses

def test_losses_match_jax(assigned):
    """detection_loss and its gradient in the predictions, both packages
    on the same targets (the port's; they equal the JAX package's)."""
    cfg = assigned[0]
    got_t = assigned[4][0]
    B, N = got_t.cls_target.shape
    rng = np.random.default_rng(3)
    preds = {"cls": rng.normal(size=(B, N)).astype(np.float32) - 2,
             "reg": (rng.normal(size=(B, N, 7)) * 0.3).astype(np.float32),
             "dir": rng.normal(size=(B, N, 2)).astype(np.float32)}
    jt = jtargets.AnchorTargets(
        *(jnp.asarray(t.numpy()) for t in got_t))._replace(
        reg_target=jnp.asarray(got_t.reg_target.transpose(1, 2).numpy()),
        dir_target=jnp.asarray(got_t.dir_target.numpy().astype(np.int32)))

    def jloss(p):
        return jlosses.detection_loss(p, jt, cfg.loss)
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in preds.items()}
    tl, tm = tlosses.detection_loss(tp, got_t, tcfg.tiny_config().loss)
    tl.backward()
    _close(tl.item(), float(jl), "loss", atol=0, rtol=1e-5)
    assert set(tm) == set(jm)
    for k in tm:
        _close(tm[k].item(), float(jm[k]), k, atol=0, rtol=1e-5)
    for k in preds:
        _close(tp[k].grad.numpy(), jg[k], f"d loss / d {k}", atol=1e-6,
               rtol=1e-5)


# ------------------------------------------------------ (d) schedule, AdamW

def test_schedule_matches_optax():
    t = jcfg.tiny_config().train
    t = dataclasses.replace(t, num_steps=1000, warmup_steps=300)
    ours = lr_schedule(t)
    theirs = optax.warmup_cosine_decay_schedule(
        t.learning_rate * 0.01, t.learning_rate, t.warmup_steps,
        max(t.num_steps, t.warmup_steps + 1), t.learning_rate * 0.01)
    # optax computes in float32: a few ulps at the scale of the peak
    for step in (0, 299, 300, 650, 1000, 1200):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6,
                                   atol=4 * 2.0 ** -24 * t.learning_rate,
                                   err_msg=f"lr at {step}")


@pytest.mark.parametrize("grad_scale", [100.0, 0.01])
def test_adamw_matches_optax(grad_scale):
    """Three updates of clip-by-global-norm + AdamW (weight decay on every
    leaf) against the JAX package's `make_optimizer`; with grad_scale 100
    the grads' norm exceeds grad_clip_norm and is clipped."""
    cfg = jcfg.tiny_config()
    rng = np.random.default_rng(5)
    params = [rng.normal(size=s).astype(np.float32) for s in
              [(3, 4), (7,), (2, 2, 5)]]
    grads = [[(rng.normal(size=p.shape) * grad_scale).astype(np.float32)
              for p in params] for _ in range(3)]
    tx = jax_optimizer(cfg)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.tensor(p) for p in params]
    opt = AdamW(tp, lr_schedule(cfg.train), cfg.train.weight_decay,
                cfg.train.grad_clip_norm)
    for g in grads:
        norm = float(global_norm([torch.tensor(x) for x in g]))
        assert (norm > cfg.train.grad_clip_norm) == (grad_scale > 1)
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.tensor(x) for x in g])
    for a, b in zip(tp, jp):
        _close(a.numpy(), b, "params", atol=0, rtol=1e-6)
    assert opt.count == 3


# ------------------------------------------------- (e) the full train step

@pytest.fixture(scope="module")
def two_steps():
    """Two train steps of the tiny float32 detector (EMA on) in both
    packages, each from the same state: the first from the port's seeded
    parameters, the second from the JAX package's state after the first
    (copied into the port: parameters, AdamW moments and count, EMA), so
    that float32 noise of the first step does not compound into the
    second. Per step: the metrics, the gradients and the updated
    parameters and EMA."""
    cfg_j = _f32(jcfg.tiny_config(True), ema_decay=0.9)
    cfg_t = _f32(tcfg.tiny_config(True), ema_decay=0.9)
    batch = _batch(cfg_j, (0, 1))
    model = init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    params = jax.tree.map(jnp.asarray, to_flax(model))

    jmodel = JaxDetector(cfg_j)
    step = jax_train_step(cfg_j, jmodel)
    loss_fn = build_loss_fn(cfg_j, jmodel)

    @jax.jit
    def jstep(state, b, pack):
        grads = jax.grad(lambda p: loss_fn(p, b, pack)[0])(state.params)
        new_state, metrics = step(state, b, pack)
        return new_state, metrics, grads

    from dcf.models.anchors import anchor_pack as jax_anchor_pack
    jpack = {k: jnp.asarray(v) for k, v in jax_anchor_pack(cfg_j).items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jax_train_state(cfg_j, params)

    state = create_train_state(cfg_t, model)
    tstep = make_train_step(cfg_t, model, "cpu")
    tb = batch_to_device({k: v for k, v in batch.items()
                          if k != "fusion_row_cum"}, "cpu")
    tpack = anchor_pack(cfg_t, "cpu")
    out = []
    for i in range(2):
        if i:
            _load_jax_state(state, jax.device_get(jstate), cfg_t)
        jstate, jm, jg = jstep(jstate, jb, jpack)
        state, tm = tstep(state, tb, tpack)
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in tm.items()},
                    jax.device_get(jg), grads_to_flax(model),
                    jax.device_get(jstate.params), to_flax(model),
                    jax.device_get(jstate.ema_params),
                    {"params": _ema_tree(model, state.ema)}))
    return out


def _load_jax_state(state, jstate, cfg):
    """The JAX package's TrainState copied into the port's."""
    def tensors(tree):
        holder = load_flax(ContFuseDetector(cfg), tree["params"])
        return dict(holder.named_parameters())
    adam = jstate.opt_state[1][0]          # chain(clip, adamw): the Adam part
    with torch.no_grad():
        for name, p in tensors(jstate.params).items():
            dict(state.model.named_parameters())[name].copy_(p)
        for dst, tree in ((state.optimizer.mu, adam.mu),
                          (state.optimizer.nu, adam.nu)):
            torch._foreach_copy_(dst, list(tensors(tree).values()))
        for name, p in tensors(jstate.ema_params).items():
            state.ema[name].copy_(p)
    state.optimizer.count = int(adam.count)


def _ema_tree(model, ema):
    from dcf_torch.params import flax_tree
    return flax_tree(model, ema)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_metrics_match_jax(two_steps, step):
    want, got = two_steps[step][:2]
    assert set(got) == set(want) - {"slab_overflow"}
    assert got["num_pos"] == want["num_pos"] > 0
    for k in got:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("what", ["grads", "params", "ema"])
def test_train_step_leaves_match_jax(two_steps, step, what):
    """Every gradient leaf, every updated parameter and the EMA, leaf by
    leaf in the flax layout."""
    i = {"grads": 2, "params": 4, "ema": 6}[what]
    want, got = two_steps[step][i:i + 2]
    w, g = dict(_leaves(want)), dict(_leaves(got))
    assert set(w) == set(g) and len(w) > 50
    for path in w:
        _close(g[path], w[path], f"{what}{path}",
               atol=GRAD_ATOL if what == "grads" else ORACLE_ATOL)
    if what == "grads":
        for name in ("img_proj/kernel", "geo_kernel", "geo_bias"):
            for path in g:
                if path.endswith(name):
                    assert np.abs(g[path]).max() > 0, path


# ----------------------------------------------- (f) gradient accumulation

def test_accumulation_matches_full_batch():
    """accum_steps=2 against the full batch of 4 frames, the port alone:
    the same update, at the tolerances tests/test_train.py holds the JAX
    package's to."""
    batch = batch_to_device({k: v for k, v in _batch(
        jcfg.tiny_config(True), range(4)).items()
        if k != "fusion_row_cum"}, "cpu")
    outs = {}
    for accum in (1, 2):
        cfg = _f32(tcfg.tiny_config(True), accum_steps=accum, batch_size=4)
        model = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        state = create_train_state(cfg, model)
        state, m = make_train_step(cfg, model, "cpu")(
            state, batch, anchor_pack(cfg, "cpu"))
        outs[accum] = ({k: float(v) for k, v in m.items()},
                       [p.detach().clone() for p in model.parameters()])
    m1, m2 = outs[1][0], outs[2][0]
    assert m1["num_pos"] == m2["num_pos"] > 0
    np.testing.assert_allclose(m1["loss"], m2["loss"], rtol=2e-3)
    np.testing.assert_allclose(m1["grad_norm"], m2["grad_norm"], rtol=2e-3)
    for a, b in zip(outs[1][1], outs[2][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)


# -------------------------------------------------------- (g) checkpoints

def test_checkpoint_round_trip(tmp_path):
    cfg = _f32(tcfg.tiny_config(False), ema_decay=0.5)
    model = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    state = create_train_state(cfg, model, seed=3)
    ckpt_dir = str(tmp_path / "checkpoints")
    assert tckpt.latest_checkpoint(ckpt_dir) is None
    rng = np.random.default_rng(0)
    for s in range(1, 8):
        grads = [torch.tensor(rng.normal(size=p.shape).astype(np.float32))
                 for p in model.parameters()]
        state.optimizer.step(grads)
        state.ema["head.cls.bias"].add_(1.0)
        torch.rand(3, generator=state.generator)
        state.step = s
        path = tckpt.save_checkpoint(ckpt_dir, state, cfg, keep=3)
    assert sorted(os.listdir(ckpt_dir)) == [
        "ckpt_00000005.pt", "ckpt_00000006.pt", "ckpt_00000007.pt",
        "config.json"]
    assert tckpt.latest_checkpoint(ckpt_dir) == path
    assert tckpt.load_config(ckpt_dir) == cfg

    fresh = create_train_state(
        cfg, init_params(cfg, torch.Generator().manual_seed(9), "cpu"))
    fresh = tckpt.restore_checkpoint(path, fresh)
    assert fresh.step == 7 and fresh.optimizer.count == 7
    for (n, a), b in zip(model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(state.optimizer.mu + state.optimizer.nu,
                    fresh.optimizer.mu + fresh.optimizer.nu):
        assert torch.equal(a, b)
    for n in state.ema:
        assert torch.equal(state.ema[n], fresh.ema[n]), n
    assert torch.equal(torch.rand(3, generator=state.generator),
                       torch.rand(3, generator=fresh.generator))
    # EMA off in the template: the saved EMA is dropped; EMA on without a
    # saved EMA: seeded from the restored parameters
    off = _f32(tcfg.tiny_config(False))
    plain = tckpt.restore_checkpoint(path, create_train_state(
        off, init_params(off, torch.Generator(), "cpu")))
    assert plain.ema is None
    tckpt.save_checkpoint(str(tmp_path / "no_ema"), plain, off)
    seeded = tckpt.restore_checkpoint(
        tckpt.latest_checkpoint(str(tmp_path / "no_ema")),
        create_train_state(cfg, init_params(cfg, torch.Generator(), "cpu")))
    for n, p in seeded.model.named_parameters():
        assert torch.equal(seeded.ema[n], p), n


# --------------------------------------------- (h) augmentation and loader

@pytest.fixture(scope="module")
def gt_dbs():
    frames = [(jsyn.make_varied_frame(seed=s), tsyn.make_varied_frame(seed=s))
              for s in range(6)]
    return (jaug.GTDatabase.build([j for j, _ in frames]),
            taug.GTDatabase.build([t for _, t in frames]), frames)


def _frame_equal(a, b):
    for key in ("points", "image", "boxes", "labels", "difficulty",
                "truncated", "occluded", "alpha", "bbox2d"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key),
                                      err_msg=key)
    assert list(a.names) == list(b.names)
    np.testing.assert_array_equal(a.calib.velo_to_image_matrix,
                                  b.calib.velo_to_image_matrix)


def test_gt_database_equal(gt_dbs):
    jdb, tdb, _ = gt_dbs
    assert set(jdb.db) == set(tdb.db)
    for name in jdb.db:
        assert len(jdb.db[name]) == len(tdb.db[name])
        for a, b in zip(jdb.db[name], tdb.db[name]):
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
    assert sum(len(v) for v in tdb.db.values()) > 5


@pytest.mark.parametrize("seed,lidar_only", [(0, False), (1, False),
                                             (2, True)])
def test_augment_frame_bit_equal(gt_dbs, seed, lidar_only):
    jdb, tdb, frames = gt_dbs
    jf, tf = frames[seed]
    aug = jcfg.tiny_config().augment
    a = jaug.augment_frame(jf, aug, np.random.default_rng(seed), jdb,
                           lidar_only)
    b = taug.augment_frame(tf, tcfg.tiny_config().augment,
                           np.random.default_rng(seed), tdb, lidar_only)
    _frame_equal(a, b)
    assert len(b.boxes) > len(tf.boxes)         # gt-sampling pasted some


def test_loader_batches_match(gt_dbs):
    """Two epochs of a 4-frame dataset in batches of 2: every key
    bit-equal but the image (within one uint8 level, 1/255)."""
    jdb, tdb, _ = gt_dbs

    class Frames:
        def __init__(self, make):
            self.make = make

        def __len__(self):
            return 4

        def __getitem__(self, i):
            return self.make(seed=i)

    jl = jload.Loader(Frames(jsyn.make_varied_frame), jcfg.tiny_config(),
                      gt_db=jdb, seed=4, num_workers=2)
    tl = tload.Loader(Frames(tsyn.make_varied_frame), tcfg.tiny_config(),
                      gt_db=tdb, seed=4, num_workers=2)
    n = 0
    for jb, tb in zip(_take(jload.infinite_batches(jl), 4),
                      _take(tload.infinite_batches(tl), 4)):
        assert set(tb) == set(jb) - {"fusion_row_cum"}
        for key in tb:
            if key == "image":
                np.testing.assert_allclose(tb[key], jb[key], rtol=0,
                                           atol=1.0001 / 255)
            else:
                np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
        n += 1
    assert n == 4


def _take(it, n):
    try:
        for _ in range(n):
            yield next(it)
    finally:
        it.close()


def test_synthetic_dataset_matches():
    from dcf.cli.common import SyntheticDataset as JaxSynthetic
    j, t = JaxSynthetic(3), tsyn.SyntheticDataset(3)
    assert len(j) == len(t) == 3
    for i in range(3):
        _frame_equal(j[i], t[i])
        assert j[i].frame_id == t[i].frame_id
    v = tsyn.SyntheticDataset(2, varied=True)
    _frame_equal(jsyn.make_varied_frame(seed=1), v[1])
