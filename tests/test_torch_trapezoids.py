"""The port's 2-D concurrent trapezoid scheme against the JAX package's.

``decompose``, ``trapezoid_map`` and ``total_grid_cells`` are host-side
integer maps, so the port is held bit-equal to ``repro.core.trapezoids``
on numpy and torch inputs alike.
"""

import doctest

import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.core import trapezoids as RT
from repro_torch import core as TC
from repro_torch.core import trapezoids as TT

SIDES = [3, 5, 27, 100, 777, 1000, 1023]


def _pieces(t):
    return [(p.offset, p.side, p.overshoot) for p in t]


@pytest.mark.parametrize("n", SIDES + [1, 2, 7, 65535])
@pytest.mark.parametrize("threshold", [4, 2, 16])
def test_decompose_and_cells(n, threshold):
    got, want = TT.decompose(n, threshold), RT.decompose(n, threshold)
    assert _pieces(got) == _pieces(want)
    for g, w in zip(got, want):
        assert (g.grid_shape, g.grid_cells, g.data_tiles) == (w.grid_shape, w.grid_cells,
                                                               w.data_tiles)
    assert TT.total_grid_cells(n, threshold) == RT.total_grid_cells(n, threshold)
    assert sum(p.data_tiles for p in got) == n * (n + 1) // 2


@pytest.mark.parametrize("n", SIDES)
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_trapezoid_map_bit_equal(n, backend):
    for tp, tr in zip(TT.decompose(n), RT.decompose(n)):
        w, h = tr.grid_shape
        wx, wy = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
        wx, wy = wx.ravel(), wy.ravel()
        want = RT.trapezoid_map(tr, wx, wy)
        args = (wx, wy) if backend == "numpy" else (torch.from_numpy(wx), torch.from_numpy(wy))
        got = TT.trapezoid_map(tp, *args)
        if backend == "torch":
            assert all(isinstance(g, torch.Tensor) for g in got)
        for g, r in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(r))


@pytest.mark.parametrize("n", SIDES)
def test_scheme_covers_triangle_once(n):
    seen = np.zeros((n, n), np.int64)
    for t in TT.decompose(n):
        w, h = t.grid_shape
        wx, wy = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
        x, y, v = TT.trapezoid_map(t, wx.ravel(), wy.ravel())
        np.add.at(seen, (y[v], x[v]), 1)
    assert np.array_equal(seen, np.tri(n, dtype=np.int64))


def test_core_exports_and_errors():
    assert TC.decompose is TT.decompose and TC.Trapezoid is TT.Trapezoid
    assert TC.trapezoid_map is TT.trapezoid_map
    assert TC.total_grid_cells is TT.total_grid_cells
    with pytest.raises(ValueError, match="n >= 1"):
        TT.decompose(0)


def test_trapezoids_doctests():
    result = doctest.testmod(TT, verbose=False)
    assert result.failed == 0 and result.attempted > 0
