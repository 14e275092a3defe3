"""The port's schedules (repro_torch.core) against the JAX package's
(repro.core): grids, steps, walk tables, piece tables and the torch
backend of every map, bit for bit, over the sweeps of test_schedule.py
and test_composite.py."""

import doctest

import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.core import schedule as RS
from repro.core import trapezoids as RT
from repro_torch.core import hmap as TH
from repro_torch.core import maps_baseline as TMB
from repro_torch.core import schedule as TS
from repro_torch.core import trapezoids as TT
from repro_torch.state import load_state

NON_POW2 = [n for n in range(3, 25) if n & (n - 1)]
CASES = [
    (m, n, kind)
    for m, ns in [(2, [4, 16, 6, 12]), (3, [4, 8, 6]), (4, [4, 8, 5])]
    for n in ns
    for kind in RS.registered_kinds(m)
    if not ((kind in ("hmap", "octant") and n & (n - 1)) or (kind == "rb" and n % 2))
] + [(m, n, "composite") for m in (2, 3, 4) for n in NON_POW2]


def _ids(case):
    return "m{}-n{}-{}".format(*case)


def _torch_table(sched):
    lin = torch.arange(sched.steps)
    ws = []
    for g in sched.grid:
        ws.append(lin % g)
        lin = lin // g
    if sched.prefetch is not None:
        ws.append(torch.from_numpy(sched.prefetch))
    out = sched.map(*ws)
    cols = [c.to(torch.int64) for c in out[:-1]] + [out[-1].to(torch.int64)]
    return torch.stack(cols, 1).numpy().astype(np.int32)


def test_registered_kinds_match():
    for m in (2, 3, 4, 5):
        assert TS.registered_kinds(m) == RS.registered_kinds(m)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_schedule_bit_equal(case):
    m, n, kind = case
    ref, port = RS.SimplexSchedule(m, n, kind), TS.SimplexSchedule(m, n, kind)
    assert port.grid == ref.grid
    assert port.steps == ref.steps and port.useful == ref.useful
    assert port.waste() == ref.waste()
    assert port.asymptotic_waste() == ref.asymptotic_waste()
    want = ref.table()
    assert np.array_equal(port.table(), want)
    for a, b in zip(TS.step_grid_indices(port), RS.step_grid_indices(ref)):
        assert np.array_equal(a, b)
    # the torch backend of the map equals the numpy walk
    assert np.array_equal(_torch_table(port), want)
    if ref.needs_table:
        assert np.array_equal(port.prefetch, ref.prefetch)


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("n", [6, 7, 12, 23])
def test_split_pieces_bit_equal(m, n):
    ref = RS.SimplexSchedule(m, n, "composite").split_pieces()
    port = TS.SimplexSchedule(m, n, "composite").split_pieces()
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p.grid == r.grid and p.steps == r.steps and p.useful == r.useful
        assert p.piece.groups == r.piece.groups
        lin = np.arange(p.steps)
        want = np.stack([np.asarray(c).astype(np.int64) for c in r.map(lin)], 1)
        got = np.stack([np.asarray(c).astype(np.int64) for c in p.map(lin)], 1)
        assert np.array_equal(got, want)
        tgot = np.stack([c.to(torch.int64).numpy() for c in p.map(torch.from_numpy(lin))], 1)
        assert np.array_equal(tgot, want)


@pytest.mark.parametrize("m,n", [(2, 7), (3, 11), (4, 6), (5, 9)])
def test_decompose_and_composite_map(m, n):
    ref, port = RT.decompose_simplex(m, n), TT.decompose_simplex(m, n)
    assert [p.groups for p in port] == [p.groups for p in ref]
    assert TT.composite_grid_size(m, n) == RT.composite_grid_size(m, n)
    lin = np.arange(TT.composite_grid_size(m, n))
    want = RT.composite_map(ref, m, lin)
    for got in (TT.composite_map(port, m, lin), TT.composite_map(port, m, torch.from_numpy(lin))):
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("m,n", [(3, 8), (3, 16), (4, 8), (5, 4)])
def test_hmap_recursive_backends(m, n):
    from repro.core import hmap as RH

    idx = np.arange(TH.hmap_m_grid_size(n, m))
    want = RH.hmap_m_recursive(idx, n, m)
    for got in (TH.hmap_m_recursive(idx, n, m), TH.hmap_m_recursive(torch.from_numpy(idx), n, m)):
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    prefix, sides = TH.recursive_levels(n, m)
    assert prefix[-1] == RH.hmap_m_grid_size(n, m)


def test_pow2_and_log2_backends():
    from repro.core import hmap as RH

    y = np.arange(1, 5000)
    assert np.array_equal(TH.pow2_floor(y), RH.pow2_floor(y))
    assert np.array_equal(TH.pow2_floor(torch.from_numpy(y)).numpy(), RH.pow2_floor(y))
    assert np.array_equal(TH.floor_log2(y), RH.floor_log2(y))
    assert np.array_equal(TH.floor_log2(torch.from_numpy(y)).numpy(), RH.floor_log2(y))


@pytest.mark.parametrize("n", [8, 16, 64])
def test_hmap2_and_baselines_backends(n):
    from repro.core import hmap as RH
    from repro.core import maps_baseline as RMB

    wx, wy = np.meshgrid(np.arange(n // 2), np.arange(n + 1), indexing="xy")
    wx, wy = wx.ravel(), wy.ravel()
    for port_fn, ref_fn in ((TH.hmap2_full, RH.hmap2_full), (TMB.rb_map2, RMB.rb_map2)):
        want = ref_fn(wx, wy, n)
        for got in (port_fn(wx, wy, n), port_fn(torch.from_numpy(wx), torch.from_numpy(wy), n)):
            for a, b in zip(got, want):
                assert np.array_equal(np.asarray(a), np.asarray(b))
    x, y = TH.hmap2_full(wx, wy, n)
    strict = x < y
    ix, iy = TH.hmap2_inverse(x[strict], y[strict])
    rx, ry = RH.hmap2_inverse(x[strict], y[strict])
    assert np.array_equal(ix, rx) and np.array_equal(iy, ry)
    w = np.arange(n * (n + 1) // 2)
    for a, b in zip(TMB.lambda_map2(w), RMB.lambda_map2(w)):
        assert np.array_equal(a, b)
    w3 = np.arange(n * (n + 1) * (n + 2) // 6)
    for a, b in zip(TMB.lambda_map3(w3), RMB.lambda_map3(w3)):
        assert np.array_equal(a, b)


def test_hmap3_paper_and_grid_steps():
    from repro.core import hmap as RH

    n = 8
    w = np.indices(RH.hmap3_paper_grid_shape(n)).reshape(3, -1)
    for a, b in zip(TH.hmap3_paper(*w, n), RH.hmap3_paper(*w, n)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for m, kind in ((2, "hmap"), (2, "bb"), (3, "octant"), (3, "paper"), (4, "hmap")):
        assert TS.grid_steps(16, kind, m) == RS.grid_steps(16, kind, m)


@pytest.mark.parametrize("m,n", [(2, 6), (2, 7), (3, 6), (3, 8), (4, 5), (4, 16), (5, 3)])
@pytest.mark.parametrize("kind", ["hmap", "octant", "rb", "bb", "table", "composite"])
def test_resolve_kind_matches(m, n, kind):
    if kind not in RS.registered_kinds(m):
        return
    assert TS.resolve_kind(m, n, kind) == RS.resolve_kind(m, n, kind)


def test_auto_kind_raises(monkeypatch, tmp_path):
    # 'auto' asks the autotuner for the kernel's device: None is the card,
    # which a host without one refuses; the CPU gets a concrete kind.
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_TORCH_BENCH_ARTIFACT", str(tmp_path / "BENCH_torch.json"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.resolve_kind(2, 16, "auto")
    assert TS.resolve_kind(2, 16, "auto", device="cpu") in ("hmap", "rb", "bb")


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="available"):
        TS.SimplexSchedule(3, 8, "rb")


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_folded_pairs_and_tables(n):
    assert np.array_equal(TS.folded_causal_pairs(n), RS.folded_causal_pairs(n))
    assert np.array_equal(TS.schedule2d_table(n), RS.schedule2d_table(n))
    assert np.array_equal(TS.schedule3d_table(n), RS.schedule3d_table(n))


@pytest.mark.parametrize("m,n,kind", [(2, 8, "composite"), (2, 7, "composite"),
                                      (3, 6, "composite"), (4, 5, "composite"),
                                      (2, 6, "table"), (3, 5, "table"), (4, 4, "table")])
def test_descriptor_payload_is_the_reference_state(m, n, kind):
    """The device descriptor carries exactly the JAX package's host
    payload: its table, or its composite pieces packed."""
    ref = RS.SimplexSchedule(m, n, kind)
    desc = TS.SimplexSchedule(m, n, kind).device_descriptor("cpu")
    assert desc.header.shape == (TS.HEADER_LEN,)
    assert desc.header[:4].tolist() == [TS.MAP_CODES[kind], m, n, ref.steps]
    if kind == "table":
        state = load_state(m, table=ref.prefetch, nb=n, device="cpu")
        assert torch.equal(desc.data, state.table)
    else:
        state = load_state(m, pieces=RT.decompose_simplex(m, n), device="cpu")
        assert torch.equal(desc.data, state.pieces)
        assert desc.header[6] == len(RT.decompose_simplex(m, n))


def test_descriptor_levels():
    desc = TS.SimplexSchedule(3, 16, "octant").device_descriptor("cpu")
    prefix, sides = TH.recursive_levels(16, 3)
    K = len(sides)
    assert desc.header[5] == K
    assert desc.header[8:8 + K + 1].tolist() == prefix
    off = 8 + TS.MAX_LEVELS + 1
    assert desc.header[off:off + K].tolist() == sides


@pytest.mark.parametrize("mod", [TH, TMB, TS, TT])
def test_port_core_doctests(mod):
    result = doctest.testmod(mod, verbose=False)
    assert result.failed == 0 and result.attempted > 0
