"""The port's tensor-core H map (repro_torch.kernels.hmap_mxu) on the CPU
against the JAX package's (repro.kernels.hmap_mxu, interpret mode, as
tests/test_kernels.py runs it) and against int64 arithmetic.

Every comparison is bit-equal.  The reference computes its product in
float32 and is exact only for outputs below 2^24; above that the port is
held against int64 arithmetic instead.
"""

import doctest
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.core.hmap import hmap2, pow2_floor
from repro.kernels.hmap_mxu import hmap2_coords_mxu as jax_mxu
from repro_torch.kernels import _build, ops
from repro_torch.kernels import hmap_mxu as TM


def _port(wxy, rho):
    return TM.hmap2_coords_mxu(torch.from_numpy(wxy), rho=rho, device="cpu").numpy()


def _int64(wxy, rho):
    """The map in int64 numpy arithmetic: ``rho * hmap2(wx, wy)`` where
    ``wy >= 1``, with ``b`` taken at ``max(wy, 1)`` on rows of ``wy = 0``."""
    wx, wy = wxy[:, 0].astype(np.int64), wxy[:, 1].astype(np.int64)
    b = pow2_floor(np.maximum(wy, 1))
    qb = (wx // b) * b
    out = np.stack([rho * (wx + qb), rho * (wy + 2 * qb)], 1)
    pos = wy >= 1
    x, y = hmap2(wx[pos], wy[pos])
    assert np.array_equal(out[pos], np.stack([rho * x, rho * y], 1))
    return out


def test_reference_case_vs_jax():
    # tests/test_kernels.py's case: the strict hmap2 grid of n = 64, rows of
    # ones as padding.
    n, rho = 64, 8
    wy, wx = np.meshgrid(np.arange(1, n), np.arange(n // 2), indexing="ij")
    wxy = np.stack([wx.ravel(), wy.ravel()], 1).astype(np.int32)
    wxy = np.concatenate([wxy, np.ones(((-len(wxy)) % 128, 2), np.int32)], 0)
    got = _port(wxy, rho)
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(jax_mxu(jnp.asarray(wxy), rho=rho)))
    assert np.array_equal(got, _int64(wxy, rho))


def test_wy_zero_rows_vs_jax():
    wxy = np.array([[5, 0], [0, 0], [7, 0], [3, 1]] * 32, np.int32)
    got = _port(wxy, 1)
    assert np.array_equal(got, np.asarray(jax_mxu(jnp.asarray(wxy), rho=1)))
    assert got[:4].tolist() == [[10, 10], [0, 0], [14, 14], [6, 7]]


@pytest.mark.parametrize("rho", [1, 3, 16])
def test_random_below_2_24_vs_jax(rho):
    rng = np.random.default_rng(rho)
    wxy = rng.integers(0, (1 << 22) // rho, (512, 2)).astype(np.int32)
    got = _port(wxy, rho)
    assert got.max() < 1 << 24
    assert np.array_equal(got, np.asarray(jax_mxu(jnp.asarray(wxy), rho=rho)))
    assert np.array_equal(got, _int64(wxy, rho))


def test_above_2_24_is_exact():
    # The reference rounds here in float32: (2^24 + 1, 1) gives x = 2^25, not
    # 2^25 + 2.  The port is exact wherever the output fits int32.
    rng = np.random.default_rng(7)
    wxy = np.concatenate([
        np.array([[2**24 + 1, 1], [2**29 + 3, 2**29 + 5], [2**30 - 1, 7]], np.int32),
        rng.integers(1 << 24, 1 << 29, (125, 2)).astype(np.int32),
    ])
    got = _port(wxy, 1)
    assert got[0].tolist() == [2**25 + 2, 2**25 + 3]
    assert np.array_equal(got, _int64(wxy, 1))
    assert np.array_equal(_port(wxy[:128] // 4, 4), _int64(wxy[:128] // 4, 4))


def test_ops_entry_point():
    wxy = np.random.default_rng(3).integers(0, 1000, (256, 2)).astype(np.int32)
    assert torch.equal(ops.hmap_coords_mxu(wxy, rho=8, device="cpu"),
                       torch.from_numpy(_port(wxy, 8)))
    assert "hmap_coords_mxu" in ops.__all__


def test_contract_errors():
    good = np.ones((128, 2), np.int32)
    for bad in (np.ones((128, 3), np.int32), np.ones((100, 2), np.int32),
                np.ones(128, np.int32), good.astype(np.int64), good.astype(np.float32)):
        with pytest.raises(ValueError, match="hmap_mxu"):
            TM.hmap2_coords_mxu(bad, device="cpu")


def test_kernel_refuses_before_any_build(monkeypatch):
    def no_build():
        raise AssertionError("a refused operand reached the build")

    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(ValueError, match="CUDA"):
        TM.HMAP_MXU.kernel(torch.ones((128, 2), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="T % 128"):
        TM.HMAP_MXU.kernel(torch.ones((64, 2), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="int32"):
        TM.HMAP_MXU.kernel(torch.ones((128, 2), dtype=torch.int64), 1)


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.hmap2_coords_mxu(np.ones((128, 2), np.int32))


def test_cpu_never_touches_launch_counter():
    TM.HMAP_MXU.launches = 0
    TM.hmap2_coords_mxu(np.ones((128, 2), np.int32), device="cpu")
    assert TM.launch_counts() == {"hmap_mxu": 0}


def test_kernel_issues_the_fp64_mma():
    code = re.sub(r"//[^\n]*", "", (_build.CSRC / "hmap_mxu.cu").read_text())
    assert "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64" in code
    assert "hmap2_coords_mxu_launch" in _build._SIGNATURES


def test_hmap_mxu_doctests():
    result = doctest.testmod(TM, verbose=False)
    assert result.failed == 0 and result.attempted > 0
