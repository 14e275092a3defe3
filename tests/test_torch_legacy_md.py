"""The port's frozen m >= 3 originals (repro_torch.kernels.legacy accum3d,
ca3d, accum_md) on the CPU against the JAX package's
(repro.kernels.legacy, interpret mode, as tests/test_engine_parity.py
runs it) and against the port's engine.

Every comparison is bit-equal.  Inputs come from a numpy seed, are not
symmetric under a permutation of the axes, and CA states cover the
whole cube (live cells above the tetrahedron must not count).  Sizes
stay small: one interpret-mode JAX call takes 0.2-1.5 s, a ca3d call
about 2 s.
"""

import doctest
import re

import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.kernels import legacy as JL
from repro_torch.core.schedule import resolve_kind
from repro_torch.kernels import _build
from repro_torch.kernels import engine as TE
from repro_torch.kernels import legacy as TL

RHO = 2
# (n, kind, split): every m=3 kind at n = 8, the composite walk at n = 12
# fused and one launch per piece.
ACCUM3D_CASES = [(8, k, None) for k in ("hmap", "octant", "bb", "table")] + [
    (12, "composite", False), (12, "composite", True)]
ACCUM4D_CASES = [(8, k, None) for k in ("hmap", "bb", "table")] + [(12, "composite", True)]
CA3D_KINDS = ("hmap", "bb", "table")


def _ids(case):
    return "n{}-{}-split{}".format(*case)


def _rng(n, salt):
    return np.random.default_rng(1000 * salt + n)


def _x(n, m, dtype):
    return _rng(n, m).integers(0, 97, (n,) * m).astype(dtype)


def _state(n):
    return (_rng(n, 5).random((n, n, n)) < 0.35).astype(np.int32)


def _mask(n, m):
    return np.indices((n,) * m).sum(0) < n


@pytest.mark.parametrize("case", ACCUM3D_CASES, ids=_ids)
def test_accum3d_vs_jax(case):
    n, kind, split = case
    for dtype in (np.int32, np.float32):
        x = _x(n, 3, dtype)
        xt = torch.from_numpy(x.copy())
        got = TL.accum3d(xt, rho=RHO, kind=kind, split=split, device="cpu")
        assert got.dtype == xt.dtype and torch.equal(xt, torch.from_numpy(x))
        want = np.asarray(JL.accum3d(x, rho=RHO, kind=kind, split=split))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(want, x + _mask(n, 3))
        assert torch.equal(got, TE.accum(x, rho=RHO, kind=kind, split=split, device="cpu"))
        # accum_md at m=3 is accum3d: the same (z, y, x) axes.
        assert torch.equal(TL.accum_md(x, rho=RHO, kind=kind, split=split, device="cpu"),
                           got)


@pytest.mark.parametrize("case", ACCUM4D_CASES, ids=_ids)
def test_accum_md_m4_vs_jax(case):
    n, kind, split = case
    x = _x(n, 4, np.int32)
    got = TL.accum_md(x, rho=RHO, kind=kind, split=split, device="cpu")
    want = np.asarray(JL.accum_md(x, rho=RHO, kind=kind, split=split))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, x + _mask(n, 4))
    assert torch.equal(got, TE.accum_md(x, rho=RHO, kind=kind, split=split, device="cpu"))


@pytest.mark.parametrize("kind", CA3D_KINDS)
def test_ca3d_vs_jax(kind):
    n = 8
    s = _state(n)
    assert s[~_mask(n, 3)].any()  # live cells above the tetrahedron
    got, want, eng = torch.from_numpy(s), s, s
    for _ in range(2):
        got = TL.ca3d(got, rho=RHO, kind=kind, device="cpu")
        want = np.asarray(JL.ca3d(want, rho=RHO, kind=kind))
        eng = TE.ca(eng, rho=RHO, kind=kind, device="cpu")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(got, eng)
    assert np.array_equal(got.numpy()[~_mask(n, 3)], s[~_mask(n, 3)])


def test_ca3d_composite_vs_engine():
    s = (_rng(12, 6).random((12, 12, 12)) < 0.35).astype(np.int32)
    got = TL.ca3d(s, rho=RHO, kind="composite", device="cpu")
    assert torch.equal(got, TE.ca(s, rho=RHO, kind="composite", device="cpu"))
    assert torch.equal(got, TL.ca3d(s, rho=RHO, kind="bb", device="cpu"))


def test_large_tiles_loop():
    # rho = 16 at m=3: 4096 elements per tile and an 18^3 halo.
    n, rho = 32, 16
    x = _x(n, 3, np.int64)
    assert torch.equal(TL.accum3d(x, rho=rho, kind="hmap", device="cpu"),
                       TE.accum(x, rho=rho, kind="hmap", device="cpu"))
    s = (_rng(n, 7).random((n, n, n)) < 0.35).astype(np.int32)
    assert torch.equal(TL.ca3d(s, rho=rho, kind="table", device="cpu"),
                       TE.ca(s, rho=rho, kind="table", device="cpu"))


def test_launch_plan():
    assert len(TL._launch_plan(3, 6, "composite")) == 1
    assert len(TL._launch_plan(3, 6, "composite", split=False)) == 1
    pieces = TL._launch_plan(3, 6, "hmap", split=True)  # hmap resolves to composite
    assert len(pieces) > 1 and sum(p.steps for p in pieces) == TL.grid_steps_3d(6, "hmap")
    assert [p.steps for p in pieces] == [
        p.steps for p in TE.launch_plan(3, 6, "composite", True, True)]
    assert len(TL._launch_plan(3, 8, "bb", split=True)) == 1


def test_errors(monkeypatch, tmp_path):
    x3 = _x(8, 3, np.int32)
    with pytest.raises(ValueError, match=r"use accum2d for the 2-simplex"):
        TL.accum_md(_x(8, 2, np.int32), device="cpu")
    # 'auto' asks the autotuner for the operand's device and runs its pick.
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_TORCH_BENCH_ARTIFACT", str(tmp_path / "BENCH_torch.json"))
    pick = resolve_kind(3, 8 // RHO, "auto", device="cpu")
    for call in (lambda kind: TL.accum3d(x3, rho=RHO, kind=kind, device="cpu"),
                 lambda kind: TL.accum_md(x3, rho=RHO, kind=kind, device="cpu"),
                 lambda kind: TL.ca3d(_state(8), rho=RHO, kind=kind, device="cpu")):
        assert torch.equal(call("auto"), call(pick))
    with pytest.raises(ValueError, match="m-cube"):
        TL.accum3d(_x(8, 2, np.int32), device="cpu")
    with pytest.raises(ValueError, match="m-cube"):
        TL.ca3d(np.zeros((8, 8, 4), np.int32), rho=RHO, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        TL.accum3d(x3, rho=3, device="cpu")
    with pytest.raises(ValueError, match="shared memory"):
        TL.ca3d(np.zeros((40,) * 3, np.int32), rho=40, device="cpu")


def test_kernel_wrappers_refuse_before_any_build(monkeypatch):
    def no_build():
        raise AssertionError("a refused operand reached the build")

    monkeypatch.setattr(_build, "library", no_build)
    s3 = TL._schedule(3, 4, "hmap")
    x = torch.zeros((8, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TL.ACCUM3D.kernel_(x, s3, RHO)
    with pytest.raises(ValueError, match="CUDA"):
        TL.ACCUM_MD.kernel_(x, s3, RHO)
    with pytest.raises(ValueError, match="CUDA"):
        TL.CA3D.kernel_(x.clone(), x, s3, RHO)
    with pytest.raises(ValueError, match="needs a"):
        TL.ACCUM3D.kernel_(torch.zeros((16,) * 3, dtype=torch.int32), s3, RHO)
    with pytest.raises(ValueError, match="serves m=3"):
        TL.ACCUM3D.kernel_(torch.zeros((8,) * 4, dtype=torch.int32),
                           TL._schedule(4, 4, "hmap"), RHO)
    with pytest.raises(ValueError, match="serves m=3"):
        TL.CA3D.kernel_(x.clone(), x, TL._schedule(4, 4, "bb"), RHO)
    with pytest.raises(ValueError, match="m >= 3"):
        TL.ACCUM_MD.kernel_(torch.zeros((8, 8), dtype=torch.int32),
                            TL._schedule(2, 4, "hmap"), RHO)
    with pytest.raises(ValueError, match="shared memory"):
        TL.CA3D.kernel_(torch.zeros((40,) * 3, dtype=torch.int32),
                        torch.zeros((40,) * 3, dtype=torch.int32), TL._schedule(3, 1, "bb"), 40)


@pytest.mark.parametrize("name", ["accum3d", "ca3d", "accum_md"])
def test_device_none_without_cuda_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _x(8, 3, np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(TL, name)(x, rho=RHO)


def test_cpu_never_touches_launch_counters():
    for k in (TL.ACCUM3D, TL.CA3D, TL.ACCUM_MD):
        k.launches = 0
    TL.accum3d(_x(8, 3, np.int32), rho=RHO, device="cpu")
    TL.ca3d(_state(8), rho=RHO, device="cpu")
    TL.accum_md(_x(4, 4, np.int32), rho=RHO, kind="composite", split=True, device="cpu")
    counts = TL.launch_counts()
    assert len(counts) == 7
    assert (counts["accum3d"], counts["ca3d"], counts["accum_md"]) == (0, 0, 0)


def _code(path):
    """A CUDA source without its comments."""
    text = (_build.CSRC / path).read_text()
    return re.sub(r"//[^\n]*", "", text)


def test_legacy_kernels_share_no_engine_code():
    # The originals are the engine's independent check: only the schedule
    # subsystem (SimplexMap and simplex_map) is shared with it.
    engine_only = ("simplex_block_shared", "simplex_in_domain", "simplex_offset",
                   "simplex_split", "simplex_ipow", "simplex_rho_shift", "stencil",
                   "simplex_accum", "simplex_ca", "simplex_edm", "simplex_map_launch")
    for src in ("legacy2d.cu", "legacy_md.cu"):
        code = _code(src)
        assert [w for w in engine_only if w in code] == [], src


def test_legacy_doctests():
    result = doctest.testmod(TL, verbose=False)
    assert result.failed == 0 and result.attempted > 0
