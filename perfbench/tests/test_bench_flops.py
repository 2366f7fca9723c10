"""The frozen FLOP arithmetic against the values it gave at the commit it
was copied from."""

import json

import pytest

from perfbench import flops, registry
from perfbench.reference import config

contfuse = registry.family("contfuse")


@pytest.mark.parametrize("factory, infer_g, train_g", [
    (config.multi_scale_config, 179.1, 537.3),
    (config.lidar_only_config, 140.5, 421.4)])
def test_flops_per_frame(factory, infer_g, train_g):
    cfg = factory()
    assert contfuse.inference_flops_per_frame(cfg)["total"] / 1e9 == \
        pytest.approx(infer_g, abs=0.05)
    assert contfuse.flops_per_frame(cfg, "train") / 1e9 == \
        pytest.approx(train_g, abs=0.05)


@pytest.mark.parametrize("name, infer_g, train_g", [
    ("contfuse-ms", 288.1, 864.3), ("bev-lidar", 249.5, 748.4)])
def test_flops_of_the_config_files(name, infer_g, train_g):
    """The configurations as run: the factories with the paper's BEV depth
    (residual groups of 2, 4, 6, 6 blocks)."""
    cfg = config.Config.from_json(json.dumps(registry.config(name)["config"]))
    assert cfg.backbone.bev_blocks_per_stage == (2, 4, 6, 6)
    assert contfuse.inference_flops_per_frame(cfg)["total"] / 1e9 == \
        pytest.approx(infer_g, abs=0.05)
    assert contfuse.flops_per_frame(cfg, "train") / 1e9 == \
        pytest.approx(train_g, abs=0.05)


def test_peaks():
    assert flops.H100_PEAK_BF16_FLOPS == 989e12
    assert flops.H100_HBM_BYTES_PER_S == 3.35e12
