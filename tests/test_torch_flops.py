"""`dcf_torch.utils.flops` against `dcf.utils.flops`: every FLOP
function equal on `tiny_config` and `multi_scale_config` (integer
arithmetic on the same config values), every byte entry equal where the
convention is the same, and the H100 peaks in `mfu`.

The JAX package's byte breakdown has one convention the port does not:
an in-graph space-to-depth copy of the image when `host_s2d` is off. The
port always space-to-depths on the host, so the comparison runs the JAX
configs with their default `host_s2d=True`, and a JAX config with it off
differs in the "image_backbone" entry alone.
"""

import dataclasses

import pytest

import dcf.config as jcfg
import dcf.utils.flops as JF
import dcf_torch.config as tcfg
import dcf_torch.utils.flops as TF

CONFIGS = {
    "tiny": (lambda: jcfg.tiny_config(True), lambda: tcfg.tiny_config(True)),
    "tiny_lidar": (lambda: jcfg.tiny_config(False),
                   lambda: tcfg.tiny_config(False)),
    "multi_scale": (lambda: jcfg.resolve_platform(
        jcfg.multi_scale_config(), "cpu"), tcfg.multi_scale_config),
    "lidar": (lambda: jcfg.resolve_platform(jcfg.lidar_only_config(), "cpu"),
              tcfg.lidar_only_config),
}
FLOP_FUNCTIONS = ["image_backbone_flops", "bev_backbone_flops", "fpn_flops",
                  "head_flops", "fusion_flops", "inference_flops_per_frame",
                  "train_flops_per_frame", "inference_bytes_breakdown",
                  "inference_bytes_per_frame"]


@pytest.mark.parametrize("fn", FLOP_FUNCTIONS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_counts_match_jax(name, fn):
    make_j, make_t = CONFIGS[name]
    assert getattr(TF, fn)(make_t()) == getattr(JF, fn)(make_j())


def test_helpers_match_jax():
    assert TF._conv_flops(10, 20, 3, 8, 3) == JF._conv_flops(10, 20, 3, 8, 3)
    for stride in (1, 2):
        assert TF._basic_block_flops(8, 8, 16, 24, stride) == \
            JF._basic_block_flops(8, 8, 16, 24, stride)


def test_in_graph_s2d_is_the_one_byte_convention_apart():
    j = jcfg.resolve_platform(jcfg.multi_scale_config(), "cpu")
    j = dataclasses.replace(j, image=dataclasses.replace(j.image,
                                                         host_s2d=False))
    got = TF.inference_bytes_breakdown(tcfg.multi_scale_config())
    want = JF.inference_bytes_breakdown(j)
    assert {k for k in got if got[k] != want[k]} == {"image_backbone"}


def test_mfu_uses_the_h100_peaks():
    ach, frac = TF.mfu(100e9, 50.0)     # 100 GFLOP at 50 fps = 5 TFLOP/s
    assert ach == pytest.approx(5.0)
    assert frac == pytest.approx(5e12 / 989e12)
    assert TF.mfu(1e12, 1.0, peak=TF.H100_PEAK_INT8_OPS)[1] == \
        pytest.approx(1e12 / 1979e12)
    assert (TF.H100_PEAK_F32_FLOPS, TF.H100_HBM_BYTES_PER_S) == (67e12,
                                                                 3.35e12)
