"""The port's frozen 2-D originals (repro_torch.kernels.legacy) on the
CPU against the JAX package's (repro.kernels.legacy, interpret mode, as
tests/test_engine_parity.py runs it) and against the port's engine; the
deprecated shims and Schedule2D.

MAP, ACCUM and CA are bit-equal.  EDM is held to atol = rtol = 1e-5:
float32 sums over d run in another order in the two frameworks.  Sizes
stay small: one interpret-mode JAX legacy call takes 0.1-0.6 s.
"""

import doctest
import warnings

import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.core import schedule as JS
from repro.kernels import legacy as JL
from repro_torch.core import schedule as TS
from repro_torch.kernels import _build
from repro_torch.kernels import engine as TE
from repro_torch.kernels import legacy as TL
from repro_torch.kernels import simplex_kernels as TSK

KINDS = ("hmap", "rb", "bb")
RHO = 4
CASES = [(n, kind) for n in (16, 24) for kind in KINDS]


def _ids(case):
    return "n{}-{}".format(*case)


def _rng(n, salt):
    return np.random.default_rng(1000 * salt + n)


def _x(n, dtype):
    return _rng(n, 1).integers(0, 97, (n, n)).astype(dtype)


def _points(n):
    return _rng(n, 2).standard_normal((n, 5)).astype(np.float32)


def _state(n):
    # Not masked to the triangle: the halo mask must drop the live cells above it.
    return (_rng(n, 3).random((n, n)) < 0.4).astype(np.int32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nb", [4, 6])
def test_map2d_vs_jax(nb, kind):
    got = TL.map2d(nb, kind, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(JL.map2d(nb, kind)))
    assert torch.equal(got, TE.map_table(nb, m=2, kind=kind, device="cpu"))
    assert torch.equal(TL.map2d(nb, kind, chunk=5, device="cpu"), got)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_accum2d_vs_jax(case):
    n, kind = case
    for dtype in (np.int32, np.float32):
        x = _x(n, dtype)
        xt = torch.from_numpy(x.copy())
        got = TL.accum2d(xt, rho=RHO, kind=kind, device="cpu")
        assert got.dtype == xt.dtype and torch.equal(xt, torch.from_numpy(x))
        assert np.array_equal(got.numpy(), np.asarray(JL.accum2d(x, rho=RHO, kind=kind)))
        assert torch.equal(got, TE.accum(x, rho=RHO, kind=kind, device="cpu"))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_edm2d_vs_jax(case):
    n, kind = case
    p = _points(n)
    got = TL.edm2d(p, rho=RHO, kind=kind, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(JL.edm2d(p, rho=RHO, kind=kind)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, TE.edm2d(p, rho=RHO, kind=kind, device="cpu").numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not np.triu(got, 1).any()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_ca2d_vs_jax(case):
    n, kind = case
    s = _state(n)
    got = TL.ca2d(s, rho=RHO, kind=kind, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(JL.ca2d(s, rho=RHO, kind=kind)))
    assert torch.equal(got, TE.ca(s, rho=RHO, kind=kind, device="cpu"))
    assert np.array_equal(np.triu(got.numpy(), 1), np.triu(s, 1))


def test_large_tiles_loop():
    # rho = 64: 4096 elements per tile and a 66^2 halo, more than one block's threads.
    n, rho = 128, 64
    x = _x(n, np.int64)
    assert torch.equal(TL.accum2d(x, rho=rho, kind="hmap", device="cpu"),
                       TE.accum(x, rho=rho, kind="hmap", device="cpu"))
    s = _state(n)
    assert torch.equal(TL.ca2d(s, rho=rho, kind="bb", device="cpu"),
                       TE.ca(s, rho=rho, kind="bb", device="cpu"))


def test_kind_errors(monkeypatch, tmp_path):
    for kind in ("table", "composite"):
        with pytest.raises(ValueError, match=r"launch a \(w, h\) grid"):
            TL.map2d(4, kind, device="cpu")
        with pytest.raises(ValueError, match=r"launch a \(w, h\) grid"):
            TL.accum2d(_x(16, np.int32), rho=RHO, kind=kind, device="cpu")
    # 'auto' asks the autotuner for the operand's device and runs the
    # (w, h) kind it picks; with no device, a host without a card refuses.
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_TORCH_BENCH_ARTIFACT", str(tmp_path / "BENCH_torch.json"))
    pick = TS.resolve_kind(2, 16 // RHO, "auto", device="cpu")
    assert pick in KINDS
    calls = {
        "map2d": lambda kind: TL.map2d(16 // RHO, kind, device="cpu"),
        "accum2d": lambda kind: TL.accum2d(_x(16, np.int32), rho=RHO, kind=kind, device="cpu"),
        "edm2d": lambda kind: TL.edm2d(_points(16), rho=RHO, kind=kind, device="cpu"),
        "ca2d": lambda kind: TL.ca2d(_state(16), rho=RHO, kind=kind, device="cpu"),
    }
    for name, call in calls.items():
        assert torch.equal(call("auto"), call(pick)), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TL.grid_steps_2d(4, "auto")
    # accum_md serves m >= 3 (the reference asserts); the 2-simplex is accum2d's.
    with pytest.raises(ValueError, match=r"use accum2d for the 2-simplex"):
        TL.accum_md(_x(16, np.int32), rho=RHO, device="cpu")


def test_grid_steps_vs_jax():
    for nb in (1, 4, 5, 6, 16):
        for kind in KINDS:
            assert TL.grid_steps_2d(nb, kind) == JL.grid_steps_2d(nb, kind)
    for nb in (4, 6, 8):
        for kind in ("hmap", "octant", "bb", "table", "composite"):
            assert TL.grid_steps_3d(nb, kind) == JL.grid_steps_3d(nb, kind)


def test_schedule2d_vs_jax():
    for n, kind in [(8, "hmap"), (8, "rb"), (8, "bb"), (6, "rb"), (5, "bb")]:
        with pytest.warns(DeprecationWarning, match="Schedule2D is deprecated"):
            got = TS.Schedule2D(n, kind)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want = JS.Schedule2D(n, kind)
        assert (got.n, got.kind, got.grid, got.steps, got.useful) == (
            want.n, want.kind, want.grid, want.steps, want.useful)
        assert np.array_equal(got.table(), want.table())
        wx, wy = np.arange(got.grid[0]), np.ones(got.grid[0], np.int64)
        for a, b in zip(got.map(wx, wy), want.map(wx, wy)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.warns(DeprecationWarning), pytest.raises(AssertionError):
        TS.Schedule2D(8, "table")


X2, P2, S2 = _x(16, np.int32), _points(16), _state(16)
X3 = _x(8, np.int32)[:, :, None].repeat(8, axis=2)
SHIMS = {
    "map2d": (lambda: TSK.map2d(4, device="cpu"),
              lambda: TE.map_table(4, m=2, device="cpu"), "map_table"),
    "accum2d": (lambda: TSK.accum2d(X2, rho=RHO, kind="rb", device="cpu"),
                lambda: TE.accum(X2, rho=RHO, kind="rb", device="cpu"), "accum"),
    "edm2d": (lambda: TSK.edm2d(P2, rho=RHO, device="cpu"),
              lambda: TE.edm2d(P2, rho=RHO, device="cpu"), "edm2d"),
    "ca2d": (lambda: TSK.ca2d(S2, rho=RHO, kind="bb", device="cpu"),
             lambda: TE.ca(S2, rho=RHO, kind="bb", device="cpu"), "ca"),
    "accum3d": (lambda: TSK.accum3d(X3, rho=2, kind="octant", device="cpu"),
                lambda: TE.accum(X3, rho=2, kind="octant", device="cpu"), "accum"),
    "ca3d": (lambda: TSK.ca3d((X3 % 2).astype(np.int32), rho=2, device="cpu"),
             lambda: TE.ca((X3 % 2).astype(np.int32), rho=2, device="cpu"), "ca"),
    "accum_md": (lambda: TSK.accum_md(X3, rho=2, kind="table", split=True, device="cpu"),
                 lambda: TE.accum_md(X3, rho=2, kind="table", device="cpu"), "accum_md"),
    "grid_steps_2d": (lambda: TSK.grid_steps_2d(6, "hmap"),
                      lambda: TE.grid_steps(6, "hmap", m=2), "grid_steps"),
    "grid_steps_3d": (lambda: TSK.grid_steps_3d(6, "hmap"),
                      lambda: TE.grid_steps(6, "hmap", m=3), "grid_steps"),
}


@pytest.mark.parametrize("name", sorted(SHIMS))
def test_shims_warn_and_equal_engine(name):
    shim, engine_call, new = SHIMS[name]
    match = (rf"repro_torch\.kernels\.simplex_kernels\.{name} is deprecated; use "
             rf"repro_torch\.kernels\.engine\.{new}")
    with pytest.warns(DeprecationWarning, match=match):
        got = shim()
    want = engine_call()
    if isinstance(want, int):
        assert got == want
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_kernel_wrappers_refuse_before_any_build(monkeypatch):
    def no_build():
        raise AssertionError("a refused operand reached the build")

    monkeypatch.setattr(_build, "library", no_build)
    sched = TL._schedule(2, 4, "hmap")
    x = torch.zeros((16, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TL.MAP2D.kernel(sched, 128, "cpu")
    with pytest.raises(ValueError, match="1..1024"):
        TL.MAP2D.kernel(sched, 2048, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        TL.ACCUM2D.kernel_(x, sched, RHO)
    with pytest.raises(ValueError, match="CUDA"):
        TL.EDM2D.kernel_(x.float(), torch.zeros((16, 5)), sched, RHO)
    with pytest.raises(ValueError, match="CUDA"):
        TL.CA2D.kernel_(x.clone(), x, sched, RHO)
    with pytest.raises(ValueError, match="square"):
        TL.ACCUM2D.kernel_(torch.zeros((16, 8), dtype=torch.int32), sched, RHO)
    with pytest.raises(ValueError, match="needs a"):
        TL.ACCUM2D.kernel_(torch.zeros((32, 32), dtype=torch.int32), sched, RHO)
    with pytest.raises(ValueError, match="must divide"):
        TL.CA2D.kernel_(x.clone(), x, sched, 5)
    with pytest.raises(ValueError, match="points"):
        TL.EDM2D.kernel_(x.float(), torch.zeros((8, 5)), sched, RHO)
    with pytest.raises(ValueError, match="shared memory"):
        TL.EDM2D.kernel_(x.float(), torch.zeros((16, 1 << 14)), sched, RHO)
    with pytest.raises(ValueError, match="shared memory"):
        TL.edm2d(torch.zeros((64, 8192)), rho=64, device="cpu")
    with pytest.raises(ValueError, match="m=2 hmap/rb/bb"):
        TL.ACCUM2D.kernel_(x, TS.SimplexSchedule(2, 4, "table"), RHO)


@pytest.mark.parametrize("name", ["map2d", "accum2d", "edm2d", "ca2d"])
def test_device_none_without_cuda_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"map2d": lambda: TL.map2d(4), "accum2d": lambda: TL.accum2d(X2, rho=RHO),
            "edm2d": lambda: TL.edm2d(P2, rho=RHO), "ca2d": lambda: TL.ca2d(S2, rho=RHO)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call[name]()


def test_cpu_never_touches_launch_counters():
    for k in (TL.MAP2D, TL.ACCUM2D, TL.EDM2D, TL.CA2D, TL.ACCUM3D, TL.CA3D, TL.ACCUM_MD):
        k.launches = 0
    TL.map2d(4, device="cpu")
    TL.accum2d(X2, rho=RHO, device="cpu")
    TL.edm2d(P2, rho=RHO, device="cpu")
    TL.ca2d(S2, rho=RHO, device="cpu")
    assert TL.launch_counts() == {"map2d": 0, "accum2d": 0, "edm2d": 0, "ca2d": 0,
                                  "accum3d": 0, "ca3d": 0, "accum_md": 0}


def test_legacy_doctests():
    result = doctest.testmod(TL, verbose=False)
    assert result.failed == 0 and result.attempted > 0
