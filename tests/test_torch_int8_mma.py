"""The int8 / bf16 selection-product micro-benchmark: the port's plain
version against the TPU kernel it replaces.

`scripts/bench_int8_fusion_matmul.py::_kernel` runs here through
`pl.pallas_call(..., interpret=True)` with one program, on the same numpy
inputs as the port's `selection_mma_plain` (float64 arithmetic of the
same loop). int8: exact (every product and sum is an integer below
2^24). bf16: the TPU kernel sums in float32, so within
`selection_mma_tolerance`, the bound on a float32 sum of that many terms.
The CUDA kernels are held to the plain version on the card, in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dcf_torch.ops.int8_mma as M

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tpu_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_int8_fusion_matmul",
        os.path.join(REPO, "scripts", "bench_int8_fusion_matmul.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.HID, mod.CAPR, mod.W, mod.K, mod.TH, mod.REPS) == (
        M.HID, M.CAPR, M.W, M.K, M.TH, M.REPS)
    return mod


def _tpu_kernel(mod, slab, oh, in_dtype, acc_dtype):
    """One program of the TPU kernel, in interpret mode."""
    fn = pl.pallas_call(
        functools.partial(mod._kernel, in_dtype=in_dtype,
                          acc_dtype=acc_dtype),
        grid=(1,),
        in_specs=[pl.BlockSpec((M.HID, M.CAPR), lambda i: (0, 0)),
                  pl.BlockSpec((M.K, M.CAPR, M.W), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((M.HID, M.W), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((M.HID, M.W), jnp.float32),
        interpret=True)
    return np.asarray(fn(slab, oh))


def _inputs(seed, density):
    rng = np.random.default_rng(seed)
    slab = rng.integers(-128, 128, (M.HID, M.CAPR)).astype(np.int8)
    slab[0, :4] = [-128, 127, 100, -3]
    oh = (rng.uniform(size=(M.K, M.CAPR, M.W)) < density).astype(np.int8)
    normal = (rng.normal(size=(M.HID, M.CAPR)) * 8).astype(np.float32)
    return slab, oh, normal


def test_int8_plain_matches_tpu_kernel(tpu_bench):
    """Exact, on a denser 0/1 operand than the benchmark's (1 in 50, not
    1 in 512), so that each product sums several wrapped values."""
    slab, oh, _ = _inputs(0, 0.02)
    want = _tpu_kernel(tpu_bench, jnp.asarray(slab), jnp.asarray(oh),
                       jnp.int8, jnp.int32)
    got = M.selection_mma_plain(torch.from_numpy(slab), torch.from_numpy(oh))
    assert got.dtype == torch.float64 and np.abs(want).max() > 1e4
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float64))
    # on CPU tensors the entry point is the plain version, as float32
    np.testing.assert_array_equal(
        M.selection_mma_int8(torch.from_numpy(slab),
                             torch.from_numpy(oh)).numpy(), want)


def test_bf16_plain_matches_tpu_kernel(tpu_bench):
    _, oh, normal = _inputs(1, 0.02)
    slab = torch.from_numpy(normal).to(torch.bfloat16)
    ohb = torch.from_numpy(oh).to(torch.bfloat16)
    want = _tpu_kernel(tpu_bench, jnp.asarray(normal).astype(jnp.bfloat16),
                       jnp.asarray(oh).astype(jnp.bfloat16), jnp.bfloat16,
                       jnp.float32)
    got = M.selection_mma_plain(slab, ohb).numpy()
    tol = M.selection_mma_tolerance(slab, ohb).numpy()
    err = np.abs(got - want)
    assert (err <= tol).all(), (err / tol).max()
    assert np.abs(want).max() > 1e3


@pytest.mark.parametrize("i", [1, 2, 3, 77, 127, 128])
def test_int8_scaled_slab_wraps_as_jax(i):
    """s_i = int8(int32(slab) * i) wraps modulo 256 where it is formed,
    as JAX's .astype(int8) does at bench_int8_fusion_matmul.py:43-45."""
    slab = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    got = M.scaled_slab(torch.from_numpy(slab), i).numpy()
    want = np.asarray((jnp.asarray(slab).astype(jnp.int32) * i)
                      .astype(jnp.int8))
    np.testing.assert_array_equal(got, want)
    wrapped = ((slab.astype(np.int64) * i + 128) % 256 - 128).astype(np.int8)
    np.testing.assert_array_equal(got, wrapped)
    if i > 1:
        assert (got.astype(np.int64) != slab.astype(np.int64) * i).any()


def test_bf16_scaled_slab_rounds_once():
    rng = np.random.default_rng(2)
    slab = jnp.asarray((rng.normal(size=(8, 64)) * 8).astype(np.float32)
                       ).astype(jnp.bfloat16)
    for i in (3, 77, 128):
        want = np.asarray((slab * jnp.asarray(i, jnp.bfloat16))
                          .astype(jnp.float32))
        got = M.scaled_slab(torch.from_numpy(np.array(
            slab.astype(jnp.float32))).to(torch.bfloat16), i)
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_wrappers_reject_other_devices():
    slab = torch.zeros((M.HID, M.CAPR), dtype=torch.int8, device="meta")
    oh = torch.zeros((M.K, M.CAPR, M.W), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        M.selection_mma_int8(slab, oh)
    with pytest.raises(ValueError):
        M.selection_mma_bf16(slab.to(torch.bfloat16), oh.to(torch.bfloat16))
