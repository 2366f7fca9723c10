"""The port's evaluation path against the JAX package's, on the CPU.

- The devkit evaluator (`dcf_torch.eval.kitti_eval`) against
  `dcf.eval.kitti_eval` on every case of tests/test_eval.py and on random
  scenes with every label kind (DontCare, Van, Person_sitting, Truck),
  every metric (3d, bev, bbox with AOS) and num_points 0 / 11 / 40:
  every AP key equal within 1e-12. The JAX evaluator matches with
  `dcf.native` (C++) where that library is built, the port in Python.
- `run_eval` against the JAX `run_eval`: tiny_config with fusion in
  float32, the same flax parameters (`from_flax`), 5 seed-varied frames
  at batch_size 2 (the last batch padded), their images already at the
  config's size. First the detections of each
  frame: the same classes in the same order, boxes and scores within
  1e-4 (tests/test_torch_detector.py's bound); then the AP dicts within
  1e-9 at num_points 0 and 40; then the KITTI result files line for line
  (class names exact, every number within one unit of its last printed
  digit or 1e-4 of its value, the detections' bound: the scores and
  boxes carry float32 noise, which the projection of a box that reaches
  behind the camera magnifies).
"""

import dataclasses
import hashlib

import jax
import numpy as np
import pytest
import torch

import dcf.config as jcfg
import dcf.eval.kitti_eval as jke
from dcf.data.synthetic import make_varied_frame as jax_frame
from dcf.eval.evaluate import run_eval as jax_run_eval
from dcf.eval.inference import make_inference_fn as jax_inference_fn
from dcf.geometry import np_boxes as jnb
from dcf.models.detector import ContFuseDetector as JaxDetector
import dcf_torch.config as tcfg
import dcf_torch.eval.kitti_eval as tke
from dcf_torch.data.synthetic import make_varied_frame as port_frame
from dcf_torch.eval.evaluate import detect, run_eval
from dcf_torch.eval.inference import make_inference_fn
from dcf_torch.geometry import np_boxes as tnb
from dcf_torch.params import from_flax, init_params, to_flax

torch.set_num_threads(1)


# ---- the evaluator: the cases of tests/test_eval.py, in both packages ----

def _box(x, y, yaw=0.0):
    return np.array([x, y, -1.0, 3.9, 1.6, 1.56, yaw], np.float32)


def _gt(m, boxes, classes, difficulty=None):
    boxes = np.asarray(boxes, np.float32).reshape(-1, 7)
    if difficulty is None:
        difficulty = np.zeros(len(boxes), np.int32)
    return m.FrameGroundTruth(boxes7=boxes,
                              classes=np.asarray(classes, np.int32),
                              difficulty=np.asarray(difficulty, np.int32))


def _det(m, boxes, classes, scores):
    return m.FrameDetections(
        boxes7=np.asarray(boxes, np.float32).reshape(-1, 7),
        scores=np.asarray(scores, np.float32),
        classes=np.asarray(classes, np.int32))


def _anno(m, names, boxes, scores=None, heights=None, occluded=None,
          truncated=None, alphas=None, bbox2d=None):
    n = len(names)
    boxes = (np.asarray(boxes, np.float64).reshape(-1, 7) if n
             else np.zeros((0, 7)))
    if bbox2d is None:
        bbox2d = np.zeros((n, 4))
        bbox2d[:, 2] = 50.0
        bbox2d[:, 3] = np.full(n, 60.0) if heights is None else heights
    return m.Annotation(
        names=list(names), boxes7=boxes, bbox2d=np.asarray(bbox2d, float),
        truncated=(np.zeros(n) if truncated is None
                   else np.asarray(truncated, float)),
        occluded=(np.zeros(n) if occluded is None
                  else np.asarray(occluded, float)),
        alpha=None if alphas is None else np.asarray(alphas, float),
        scores=None if scores is None else np.asarray(scores, float))


def case_two_perfect(m):
    gt = [_gt(m, [_box(10, 0), _box(20, 5)], [0, 0])]
    det = [_det(m, [_box(10, 0), _box(20, 5)], [0, 0], [0.9, 0.8])]
    return {p: m.evaluate(gt, det, metric="3d", num_points=p)
            for p in (40, 11, 0)}


def case_many_perfect(m):
    rng = np.random.default_rng(0)
    gts, dets = [], []
    for f in range(5):
        boxes = [_box(8 + 6 * i, -20 + 9 * f) for i in range(10)]
        gts.append(_gt(m, boxes, [0] * 10))
        dets.append(_det(m, boxes, [0] * 10, rng.uniform(0.2, 0.99, 10)))
    return {p: m.evaluate(gts, dets, metric="3d", num_points=p)
            for p in (40, 11, 0)}


def case_fp_halves_precision(m):
    gt = [_gt(m, [_box(10, 0)], [0])]
    det = [_det(m, [_box(10, 0), _box(50, 20)], [0, 0], [0.5, 0.9])]
    return {0: m.evaluate(gt, det, metric="3d", num_points=0)}


def case_dontcare_region(m):
    gt = _anno(m, ["Car", "DontCare"], [_box(10, 0), np.zeros(7)])
    gt.bbox2d[1] = [200.0, 0.0, 300.0, 60.0]
    det = _anno(m, ["Car", "Car"], [_box(10, 0), _box(50, 20)],
                scores=[0.9, 0.95])
    det.bbox2d[1] = [210.0, 5.0, 290.0, 55.0]
    gt2 = _anno(m, ["Car"], [_box(10, 0)])
    gt2.bbox2d[0] = gt.bbox2d[0]
    det2 = _anno(m, ["Car", "Car"], [_box(10, 0), _box(50, 20)],
                 scores=[0.9, 0.95])
    det2.bbox2d[0] = gt.bbox2d[0]
    det2.bbox2d[1] = [210.0, 5.0, 290.0, 55.0]
    return {"dc": m.evaluate_annotations([gt], [det], metrics=("bbox",),
                                         num_points=0),
            "control": m.evaluate_annotations([gt2], [det2],
                                              metrics=("bbox",),
                                              num_points=0)}


def case_van_ignored(m):
    det = _anno(m, ["Car", "Car"], [_box(10, 0), _box(30, 5)],
                scores=[0.9, 0.95])
    return {other: m.evaluate_annotations(
        [_anno(m, ["Car", other], [_box(10, 0), _box(30, 5)])], [det],
        metrics=("3d",), num_points=0) for other in ("Van", "Truck")}


def case_min_height_det_filter(m):
    gt = _anno(m, ["Car", "Car"], [_box(10, 0), _box(40, 5)])
    det = _anno(m, ["Car", "Car"], [_box(10, 0), _box(40, 5)],
                scores=[0.9, 0.8], heights=[60.0, 20.0])
    return {0: m.evaluate_annotations([gt], [det], metrics=("3d",),
                                      num_points=0)}


def case_occlusion_truncation(m):
    gt = _anno(m, ["Car", "Car"], [_box(10, 0), _box(40, 5)],
               occluded=[0, 2])
    det = _anno(m, ["Car"], [_box(10, 0)], scores=[0.9])
    return {0: m.evaluate_annotations([gt], [det], metrics=("3d",),
                                      num_points=0)}


def case_aos(m):
    gt = _anno(m, ["Car", "Car"], [_box(10, 0), _box(40, 5)],
               alphas=[0.0, 1.0])
    det = _anno(m, ["Car", "Car"], [_box(10, 0), _box(40, 5)],
                scores=[0.9, 0.8], alphas=[0.0, 1.0 + np.pi])
    return {0: m.evaluate_annotations([gt], [det], metrics=("bbox",),
                                      num_points=0, compute_aos=True)}


def case_no_detections(m):
    gt = [_gt(m, [_box(10, 0)], [0])]
    det = [_det(m, np.zeros((0, 7)), [], [])]
    return {0: m.evaluate(gt, det, metric="3d", num_points=0)}


def case_false_positives(m):
    gt = [_gt(m, [_box(10, 0)], [0])]
    clean = [_det(m, [_box(10, 0)], [0], [0.9])]
    noisy = [_det(m, [_box(10, 0), _box(50, 20), _box(60, -20)],
                  [0, 0, 0], [0.5, 0.95, 0.94])]
    return {"clean": m.evaluate(gt, clean, metric="3d", num_points=0),
            "noisy": m.evaluate(gt, noisy, metric="3d", num_points=0)}


def case_localization_threshold(m):
    gt = [_gt(m, [_box(10, 0)], [0])]
    det = [_det(m, [_box(12, 0)], [0], [0.9])]
    return {0: m.evaluate(gt, det, metric="3d", num_points=0)}


def case_class_confusion(m):
    gt = [_gt(m, [_box(10, 0)], [0])]
    det = [_det(m, [_box(10, 0)], [1], [0.9])]
    return {0: m.evaluate(gt, det, metric="3d", num_points=0)}


def case_difficulty_ignore(m):
    out = {}
    for diffs, dets in (([0, 2], 2), ([1, 2], 1)):
        gt = [_gt(m, [_box(10, 0), _box(30, 5)], [0, 0], difficulty=diffs)]
        det = [_det(m, [_box(10, 0), _box(30, 5)][:dets], [0] * dets,
                    [0.9, 0.8][:dets])]
        out[tuple(diffs)] = m.evaluate(gt, det, metric="3d", num_points=0)
    return out


def case_bev_and_3d(m):
    gt = [_gt(m, [_box(10, 0)], [0])]
    b = _box(10, 0)
    b[2] += 0.8
    det = [_det(m, [b], [0], [0.9])]
    return {metric: m.evaluate(gt, det, metric=metric, num_points=0)
            for metric in ("3d", "bev")}


def case_multiframe_pooling(m):
    gt = [_gt(m, [_box(10, 0)], [0]), _gt(m, [_box(15, 2)], [0])]
    det = [_det(m, [_box(10, 0)], [0], [0.9]),
           _det(m, np.zeros((0, 7)), [], [])]
    return {0: m.evaluate(gt, det, metric="3d", num_points=0)}


NAMES = ("Car", "Pedestrian", "Cyclist", "Van", "Person_sitting", "Truck",
         "DontCare")
SIZES = {"Car": (3.9, 1.6, 1.56), "Pedestrian": (0.8, 0.6, 1.73),
         "Cyclist": (1.76, 0.6, 1.73), "Van": (5.0, 2.0, 2.2),
         "Person_sitting": (0.8, 0.6, 1.2), "Truck": (9.0, 2.5, 3.2)}


def _random_scenes(m, seed, n_frames=6):
    """Frames of ground truth with every label kind and difficulty, and
    detections jittered off them (some past the IoU thresholds, some
    with the wrong class) plus stray false positives."""
    rng = np.random.default_rng(seed)
    gts, dets = [], []
    for _ in range(n_frames):
        n = int(rng.integers(0, 9))
        names = [NAMES[i] for i in rng.integers(0, len(NAMES), n)]
        boxes = np.zeros((n, 7))
        for i, name in enumerate(names):
            if name != "DontCare":
                boxes[i] = [rng.uniform(5, 60), rng.uniform(-25, 25), -1.0,
                            *SIZES[name], rng.uniform(-np.pi, np.pi)]
        top = rng.uniform(100, 200, n)
        bbox2d = np.stack([rng.uniform(0, 1000, n), top,
                           rng.uniform(1000, 1200, n),
                           top + rng.choice([10, 24, 26, 39, 41, 80], n)],
                          -1)
        gts.append(_anno(m, names, boxes, bbox2d=bbox2d,
                         occluded=rng.integers(0, 4, n),
                         truncated=rng.choice([0.0, 0.1, 0.2, 0.4, 0.6], n),
                         alphas=rng.uniform(-np.pi, np.pi, n)))
        src = [i for i, name in enumerate(names) if name != "DontCare"]
        d_boxes, d_names, d_bbox = [], [], []
        for i in src:
            for _ in range(int(rng.integers(0, 3))):
                b = boxes[i].copy()
                b[:2] += rng.normal(0, 0.15, 2)
                b[2] += rng.normal(0, 0.1)
                b[3:6] *= rng.uniform(0.85, 1.15, 3)
                b[6] += rng.normal(0, 0.2)
                d_boxes.append(b)
                d_names.append(names[i] if names[i] in tke.CLASS_NAMES
                               and rng.uniform() < 0.85
                               else tke.CLASS_NAMES[rng.integers(0, 3)])
                d_bbox.append(bbox2d[i] + rng.normal(0, 4, 4))
        for _ in range(int(rng.integers(0, 4))):
            name = tke.CLASS_NAMES[rng.integers(0, 3)]
            d_boxes.append([rng.uniform(5, 60), rng.uniform(-25, 25), -1.0,
                            *SIZES[name], rng.uniform(-np.pi, np.pi)])
            d_names.append(name)
            y0 = rng.uniform(100, 200)
            d_bbox.append([rng.uniform(0, 1000), y0, rng.uniform(1000, 1200),
                           y0 + rng.uniform(15, 90)])
        k = len(d_names)
        # scores on a coarse grid: equal scores within and across frames
        dets.append(_anno(m, d_names, np.asarray(d_boxes).reshape(-1, 7),
                          bbox2d=np.asarray(d_bbox).reshape(-1, 4),
                          scores=rng.integers(1, 40, k) / 40.0,
                          alphas=rng.uniform(-np.pi, np.pi, k)))
    return gts, dets


def case_random_scenes(m):
    out = {}
    for seed in (0, 1, 2):
        gts, dets = _random_scenes(m, seed)
        for p in (0, 11, 40):
            out[(seed, p)] = m.evaluate_annotations(
                gts, dets, metrics=("3d", "bev", "bbox"), num_points=p,
                compute_aos=True)
    return out


CASES = [case_two_perfect, case_many_perfect, case_fp_halves_precision,
         case_dontcare_region, case_van_ignored, case_min_height_det_filter,
         case_occlusion_truncation, case_aos, case_no_detections,
         case_false_positives, case_localization_threshold,
         case_class_confusion, case_difficulty_ignore, case_bev_and_3d,
         case_multiframe_pooling, case_random_scenes]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_evaluator_matches_jax(case):
    want, got = case(jke), case(tke)
    assert got.keys() == want.keys()
    n_above = 0
    for run, w in want.items():
        assert got[run].keys() == w.keys(), run
        for key, value in w.items():
            assert abs(got[run][key] - value) <= 1e-12, (run, key)
            n_above += value > 0
    if case not in (case_no_detections, case_localization_threshold,
                    case_class_confusion):
        assert n_above > 0


def test_matching_statistics_match_jax():
    """`_frame_statistics` on random inputs against the JAX twin and, where
    it is built, the C++ core behind `dcf.native.eval_statistics`."""
    import jax_native_lib
    from dcf import native
    jax_native_lib.load()
    rng = np.random.default_rng(0)
    for _ in range(40):
        d, g = rng.integers(0, 12, 2)
        overlaps = rng.uniform(0, 1, (d, g))
        scores = rng.uniform(0, 1, d)
        ig_gt = rng.choice([-1, 0, 1], g)
        ig_det = rng.choice([-1, 0, 1], d)
        dc = (rng.uniform(0, 1, (d, rng.integers(0, 3)))
              if rng.uniform() < 0.5 else None)
        ga, da = rng.uniform(-3, 3, g), rng.uniform(-3, 3, d)
        thresholds = np.sort(rng.uniform(0, 1, 5))[::-1]
        cpp = (native.eval_statistics(overlaps, scores, ig_gt, ig_det, dc,
                                      0.5, thresholds, gt_alphas=ga,
                                      dt_alphas=da,
                                      py_fallback=jke._frame_statistics)
               if native.available() else None)
        for i, thr in enumerate(thresholds):
            args = (overlaps, scores, ig_gt, ig_det, dc, 0.5, thr)
            got = tke._frame_statistics(*args, gt_alphas=ga, dt_alphas=da)
            assert got == jke._frame_statistics(*args, gt_alphas=ga,
                                                 dt_alphas=da)
            if cpp is not None:
                assert got[:3] == (cpp[0][i], cpp[1][i], cpp[2][i])
                assert abs(got[3] - cpp[3][i]) <= 1e-12


def test_thresholds_and_overlaps_match_jax():
    rng = np.random.default_rng(1)
    for n_tp, n_gt in ((4, 4), (100, 200), (37, 41), (1, 1)):
        scores = rng.uniform(0, 1, n_tp)
        np.testing.assert_array_equal(tke.get_thresholds(scores, n_gt),
                                      jke.get_thresholds(scores, n_gt))
    a = rng.uniform(0, 100, (30, 4))
    b = rng.uniform(0, 100, (20, 4))
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    for criterion in (-1, 0):
        np.testing.assert_array_equal(
            tke.image_box_overlap(a, b, criterion),
            jke.image_box_overlap(a, b, criterion))


def test_host_iou_matches_jax():
    """The float64 host IoUs: bit-equal to `dcf.geometry.np_boxes`, and
    within 1e-12 of `dcf.native` (C++) where it is built."""
    import jax_native_lib
    from dcf import native
    jax_native_lib.load()
    rng = np.random.default_rng(2)
    n = 60
    boxes = np.stack([rng.uniform(0, 12, n), rng.uniform(-6, 6, n),
                      rng.uniform(-1.5, -0.5, n), rng.uniform(0.5, 4.5, n),
                      rng.uniform(0.4, 2.0, n), rng.uniform(1.0, 2.0, n),
                      rng.uniform(-np.pi, np.pi, n)], -1)
    a, b = boxes[:30], boxes[30:]
    bev = tnb.rotated_iou_bev(a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]])
    iou = tnb.iou_3d(a, b)
    assert (bev > 0).sum() > 20 and (iou > 0).sum() > 20
    np.testing.assert_array_equal(
        bev, jnb.rotated_iou_bev(a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]]))
    np.testing.assert_array_equal(iou, jnb.iou_3d(a, b))
    if native.available():
        np.testing.assert_allclose(bev, native.rotated_iou_bev(
            a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]]), rtol=0,
            atol=1e-12)
        np.testing.assert_allclose(iou, native.iou_3d(a, b), rtol=0,
                                   atol=1e-12)


def test_detection_annotation_matches_jax():
    """2D boxes projected from float32 corners (the JAX package's jnp
    helper, the port's numpy copy) and the observation angles."""
    from dcf.data.synthetic import default_calib as jax_calib
    from dcf_torch.data.synthetic import default_calib as port_calib
    rng = np.random.default_rng(3)
    n = 50
    boxes = np.stack([rng.uniform(3, 60, n), rng.uniform(-30, 30, n),
                      rng.uniform(-1.5, -0.5, n), rng.uniform(0.5, 4.5, n),
                      rng.uniform(0.4, 2.0, n), rng.uniform(1.4, 1.9, n),
                      rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    classes = rng.integers(0, 3, n)
    want = jke.detection_annotation(boxes, scores, classes, jax_calib(),
                                    (375, 1242, 3))
    got = tke.detection_annotation(boxes, scores, classes, port_calib(),
                                   (375, 1242, 3))
    assert got.names == want.names
    for name in ("boxes7", "scores", "alpha", "truncated", "occluded"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    # cos / sin of one float32 yaw may differ by an ulp between numpy and
    # XLA: at most 3e-3 px on the image
    np.testing.assert_allclose(got.bbox2d, want.bbox2d, rtol=0, atol=3e-3)


# ---- run_eval: the port against the JAX package end to end ----

N_FRAMES, BATCH = 5, 2


def _f32(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="float32"))


def _frames(make, cfg):
    """Seed-varied frames with their image already at the config's size,
    so that neither package resizes it: OpenCV's fixed-point resize (the
    JAX package) and the port's float resize differ by one uint8 level
    (tests/test_torch_host.py), which moves a random network's maps far
    past the parity bounds."""
    from dcf_torch.data.preprocess import resize_bilinear
    out = []
    for i in range(N_FRAMES):
        f = make(frame_id=f"{i:06d}", seed=i)
        out.append(dataclasses.replace(f, image=resize_bilinear(
            f.image, cfg.image.width, cfg.image.height)))
    return out


class _Memo:
    """An inference function that runs each distinct batch (by its
    points) once and replays the outputs after: the second `run_eval`
    of each package (num_points 40) reuses the first one's detections.
    `outputs` keeps them in the order the batches first came."""

    def __init__(self, fn, batch_of):
        self.fn, self.batch_of, self.outputs = fn, batch_of, {}

    def __call__(self, *args):
        key = hashlib.sha1(np.asarray(
            self.batch_of(*args)["points"]).tobytes()).hexdigest()
        if key not in self.outputs:
            self.outputs[key] = self.fn(*args)
        return self.outputs[key]


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    jc = jcfg.resolve_platform(_f32(jcfg.tiny_config(True)))
    jc = dataclasses.replace(jc, head=dataclasses.replace(
        jc.head, exact_topk=True))
    tc = _f32(tcfg.tiny_config(True))
    jframes, tframes = _frames(jax_frame, tc), _frames(port_frame, tc)
    # seeded flax parameters (drawn by the port's init_params: the JAX
    # package's init would compile the whole model once more)
    params = to_flax(init_params(tc, torch.Generator().manual_seed(0),
                                 device="cpu"))
    model = JaxDetector(jc)
    jax_infer = _Memo(jax.jit(jax_inference_fn(jc, model)),
                      lambda p, b, pack: b)
    port = from_flax(params, tc, device="cpu")
    port_infer = _Memo(make_inference_fn(tc, port, device="cpu"),
                       lambda b: b)
    res = {"thr": tc.head.score_threshold}
    for p in (0, 40):
        dirs = {s: str(tmp_path_factory.mktemp(f"{s}{p}"))
                for s in ("jax", "port")}
        res[("jax", p)] = jax_run_eval(
            jc, model, params, jframes, result_dir=dirs["jax"],
            num_points=p, batch_size=BATCH, infer_fn=jax_infer)
        res[("port", p)] = run_eval(
            tc, port, tframes, result_dir=dirs["port"], num_points=p,
            batch_size=BATCH, infer=port_infer, device="cpu")
        res[("dirs", p)] = dirs
    assert len(jax_infer.outputs) == len(port_infer.outputs) == 3
    res["jax_dets"] = [{k: np.asarray(v[j]) for k, v in
                        jax.device_get(out).items()}
                       for out in jax_infer.outputs.values()
                       for j in range(BATCH)][:N_FRAMES]
    _, res["port_dets"] = detect(tc, port_infer, tframes, batch_size=BATCH)
    return res


def test_run_eval_detections_match_jax(evals):
    assert len(evals["port_dets"]) == N_FRAMES     # padding dropped
    total = 0
    for got, out in zip(evals["port_dets"], evals["jax_dets"]):
        keep = out["valid"] & (out["scores"] >= evals["thr"])
        total += int(keep.sum())
        assert got.names == [tke.CLASS_NAMES[c] for c in out["classes"][keep]]
        np.testing.assert_allclose(got.boxes7, out["boxes"][keep],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.scores, out["scores"][keep],
                                   rtol=1e-4, atol=1e-4)
    assert total > 0


@pytest.mark.parametrize("num_points", [0, 40])
def test_run_eval_ap_matches_jax(evals, num_points):
    want, got = evals[("jax", num_points)], evals[("port", num_points)]
    assert got.keys() == want.keys() and len(want) == 18
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-9, key


def _fields_close(got: str, want: str) -> bool:
    g, w = got.split(), want.split()
    if len(g) != 16 or len(w) != 16 or g[0] != w[0]:
        return False
    for a, b in zip(g[1:], w[1:]):
        digits = len(b.split(".")[1]) if "." in b else 0
        if abs(float(a) - float(b)) > max(1.01 * 10.0 ** -digits,
                                          1e-4 * abs(float(b))):
            return False
    return True


@pytest.mark.parametrize("num_points", [0, 40])
def test_run_eval_result_files_match_jax(evals, num_points):
    import os
    dirs = evals[("dirs", num_points)]
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"]))
    assert names == [f"{i:06d}.txt" for i in range(N_FRAMES)]
    n_lines = n_exact = 0
    for name in names:
        with open(os.path.join(dirs["jax"], name)) as f:
            want = f.read().splitlines()
        with open(os.path.join(dirs["port"], name)) as f:
            got = f.read().splitlines()
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert _fields_close(g, w), (name, g, w)
            n_exact += g == w
        n_lines += len(want)
    assert n_lines > 0
    print(f"{n_exact} of {n_lines} result lines byte-equal")
