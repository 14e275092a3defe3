"""The port's fused executors (``kernels/compiled.py``) against the JAX
package's, and ``executor='xla'`` of the engine.

The reference evaluates a schedule walk as one XLA program; the port as
torch tensor ops on the input's device.  Both are integer walks, so the
port is bit-equal to the reference's executors and to the host-built
step list, and ``executor='xla'`` to ``executor='kernel'`` (here the
kernels' plain versions).
"""

import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.core.schedule import SimplexSchedule as RSchedule
from repro.kernels import compiled as RC
from repro_torch.core.schedule import SimplexSchedule, registered_kinds
from repro_torch.kernels import compiled as TC
from repro_torch.kernels import engine as TE
from repro_torch.kernels import ops as TO

# Pow2 and non-pow2 sides, so every kind's resolution is walked.
PARITY_MN = [(2, 4), (2, 6), (2, 7), (3, 4), (3, 6), (4, 4), (4, 5)]
# (m, n, rho) and the kinds the reference's executors are held at.
ACCUM_CASES = [(2, 16, 4, ("hmap", "rb", "bb")), (2, 24, 4, ("rb", "bb")),
               (3, 16, 4, ("hmap", "octant", "table", "composite", "bb")),
               (3, 12, 2, ("table", "composite", "bb")),
               (4, 8, 2, ("hmap", "table", "bb")), (4, 10, 2, ("composite", "table"))]


@pytest.fixture(autouse=True)
def env(tmp_path, monkeypatch):
    """Private cache and artifact paths for the tuner behind 'auto'."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_TORCH_BENCH_ARTIFACT", str(tmp_path / "BENCH_torch.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_DISABLE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_SPLIT_PIECES", raising=False)


def _constructible(m, n):
    out = []
    for kind in registered_kinds(m):
        try:
            SimplexSchedule(m, n, kind)
        except (ValueError, AssertionError):
            continue
        out.append(kind)
    return out


def _x(m, n):
    return (np.arange(n**m, dtype=np.int32).reshape((n,) * m) * 7) % 97


@pytest.mark.parametrize("m,n", PARITY_MN)
def test_schedule_coords_bit_equal(m, n):
    for kind in _constructible(m, n):
        got = TC.schedule_coords_compiled(m, n, kind, device="cpu")
        assert got.dtype == torch.int32
        want = RSchedule(m, n, kind).table()
        assert np.array_equal(got.numpy(), want), (m, n, kind)
        assert np.array_equal(got.numpy(), SimplexSchedule(m, n, kind).table())


@pytest.mark.parametrize("m,n", [(2, 6), (3, 6), (4, 5)])
def test_schedule_coords_equal_the_reference_program(m, n):
    for kind in _constructible(m, n):
        got = TC.schedule_coords_compiled(m, n, kind, device="cpu")
        assert np.array_equal(got.numpy(), RC.schedule_coords_compiled(m, n, kind)), kind


@pytest.mark.parametrize("case", ACCUM_CASES, ids=lambda c: "m{}-n{}-rho{}".format(*c[:3]))
def test_accum_compiled_bit_equal(case):
    m, n, rho, kinds = case
    x = _x(m, n)
    for kind in kinds:
        if m == 2:
            got = TC.accum2d_compiled(torch.from_numpy(x), rho=rho, kind=kind)
            want = RC.accum2d_compiled(jnp.asarray(x), rho=rho, kind=kind)
        elif m == 3:
            got = TC.accum3d_compiled(torch.from_numpy(x), rho=rho, kind=kind)
            want = RC.accum3d_compiled(jnp.asarray(x), rho=rho, kind=kind)
        else:
            got = TC.accum_md_compiled(torch.from_numpy(x), rho=rho, kind=kind)
            want = RC.accum_md_compiled(jnp.asarray(x), rho=rho, kind=kind)
        assert np.array_equal(got.numpy(), np.asarray(want)), kind


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float64])
def test_accum_compiled_keeps_the_dtype(dtype):
    x = torch.full((8, 8, 8), 127, dtype=dtype)
    got = TC.accum3d_compiled(x, rho=2, kind="octant")
    want = TE.accum(x, rho=2, kind="octant", device="cpu")
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("m,n,rho", [(2, 16, 4), (2, 12, 2), (3, 12, 2), (3, 8, 2), (4, 6, 2)])
def test_executor_xla_equals_kernel(m, n, rho):
    x = _x(m, n)
    for kind in ("auto",) + tuple(k for k in _constructible(m, n // rho)
                                  if m > 2 or k not in ("table", "composite")):
        got = TE.accum(x, rho=rho, kind=kind, device="cpu", executor="xla")
        want = TE.accum(x, rho=rho, kind=kind, device="cpu")
        assert torch.equal(got, want), kind
    got = TE.map_table(n // rho, m=m, kind="auto", device="cpu", executor="xla")
    assert torch.equal(got, TE.map_table(n // rho, m=m, kind="auto", device="cpu"))


def test_ops_exports():
    assert TO.simplex_accum2d_compiled is TC.accum2d_compiled
    assert TO.simplex_accum3d_compiled is TC.accum3d_compiled
    assert TO.simplex_accum_md_compiled is TC.accum_md_compiled


def test_xla_raises_where_the_reference_does():
    p = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="fused executor"):
        TE.SimplexKernel("edm", 2, rho=4, executor="xla", device="cpu")(p)
    with pytest.raises(NotImplementedError, match="fused executor"):
        TE.SimplexKernel("ca", 3, rho=2, executor="xla", device="cpu")(_x(3, 8))
    with pytest.raises(ValueError, match=r"\(w, h\)-grid kinds"):
        TE.accum(_x(2, 8), rho=2, kind="composite", device="cpu", executor="xla")
    with pytest.raises(ValueError, match="m >= 3"):
        TC.accum_md_compiled(torch.zeros(4, 4))
    with pytest.raises(ValueError, match="dividing"):
        TC.accum2d_compiled(torch.zeros(6, 6), rho=4)


def test_grid_shape_and_doctests():
    assert TC.compiled_grid_shape(3, 6, "hmap") == RC.compiled_grid_shape(3, 6, "hmap")
    assert TC.compiled_grid_shape(2, 6, "hmap") == RC.compiled_grid_shape(2, 6, "hmap")
    result = doctest.testmod(TC, verbose=False)
    assert result.failed == 0 and result.attempted > 0
