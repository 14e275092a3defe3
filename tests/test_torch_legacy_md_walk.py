"""The m >= 3 originals' ACCUM walk on the card, held on the CPU.

``csrc/legacy_md.cu`` runs ``accum3d`` and ``accum_md`` as one warp per
schedule step, eight steps a block: lane 0 evaluates the map, an invalid
step's warp returns, and where the host's fixed rule
``legacy.legacy_vector_access(rho, itemsize, data_ptr)`` says so each lane
reads and writes whole 16-byte pieces of a tile row, two at a time.  A
piece's run along the last axis, ``n - (sum of the other coordinates) -
first``, is computed once: a piece whose first element lies off the
domain is left alone, and in a piece on the domain's edge the elements
past it are written back unchanged.  Where the rule says no (a tile row
that is not a whole number of pieces, or an array that does not start on
a 16-byte boundary) each lane takes single elements.

Here, with numpy and no JAX call:

* the rule at every ACCUM dtype and ``rho`` in {1, 2, 3, 4, 8, 16}, on an
  aligned array and on a misaligned view;
* an emulation of the kernel's walk (the blocks' warps and their steps,
  each lane's pieces ``lane, lane + 32, ...`` with the tile's last axis
  fastest, the per-piece run, the masked read-modify-write of 16 bytes
  through a byte view of the array) bit-equal to ``ACCUM3D.plain_`` and
  ``ACCUM_MD.plain_`` at m = 3, 4 and 5 for hmap, bb, table and composite,
  fused and split; in every ACCUM dtype with each type's edge values
  (integers wrap, bfloat16 and float16 round); at a ``rho`` that is not a
  power of two (the kernel divides there); and on a misaligned view,
  where it takes the scalar path and leaves its neighbours alone.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro_torch.kernels import legacy as TL
from repro_torch.kernels import policy

WARP = 32
WARPS = 8  # steps a block (LEGACY_ACCUM_WARPS)
UNROLL = 2  # pieces a lane has in flight (LEGACY_ACCUM_UNROLL)
NP = {torch.int8: np.int8, torch.uint8: np.uint8, torch.int16: np.int16,
      torch.int32: np.int32, torch.int64: np.int64, torch.bfloat16: ml_dtypes.bfloat16,
      torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}
# Values where +1 leaves the easy range: integers at their top (they
# wrap), floats where the sum rounds.
EDGES = {torch.int8: [127, 126, -128, -1], torch.uint8: [255, 254, 0, 1],
         torch.int16: [32767, 32766, -32768, -1], torch.int32: [2**31 - 1, -1, 7],
         torch.int64: [2**63 - 1, -1, 7], torch.bfloat16: [255, 256, 258, 260],
         torch.float16: [2047, 2048, 2050, 2051], torch.float32: [2.0**24 - 1, 2.0**24, 3.5],
         torch.float64: [2.0**53 - 1, 2.0**53, 0.25]}


def _name(t):
    return str(t).split(".")[-1]


def _values(count: int, dtype, seed: int) -> np.ndarray:
    """Small values with the type's edges on every third element."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 100, count)
    pick = rng.integers(0, len(EDGES[dtype]), len(flat[::3]))
    if not dtype.is_floating_point:
        flat[::3] = np.asarray(EDGES[dtype], np.int64)[pick]
        return flat.astype(NP[dtype])
    flat = flat.astype(np.float64)
    flat[::3] = np.asarray(EDGES[dtype], np.float64)[pick]
    return flat.astype(NP[dtype])


def _aligned(count: int, dtype, lead_bytes: int = 0):
    """``(store, x)``: a byte buffer and a flat array of ``count`` elements
    in it that starts ``lead_bytes`` past a 16-byte boundary."""
    size = np.dtype(NP[dtype]).itemsize
    store = np.zeros(count * size + 64, np.uint8)
    start = -store.ctypes.data % 16 + lead_bytes
    x = store[start:start + count * size].view(NP[dtype])
    assert (x.ctypes.data - lead_bytes) % 16 == 0
    return store, x


def _torch(x: np.ndarray, dtype) -> torch.Tensor:
    """A tensor on the same memory as ``x``."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _add_one(v: np.ndarray) -> np.ndarray:
    """+1 in the array's own type as ``dtypes.cuh`` does it: integers
    wrap, 16-bit floats widen to float32 and round to nearest even."""
    if v.dtype in (np.dtype(ml_dtypes.bfloat16), np.dtype(np.float16)):
        return (v.astype(np.float32) + np.float32(1)).astype(v.dtype)
    return v + v.dtype.type(1)


def _steps(sched) -> np.ndarray:
    """``(S, m)`` array-axis tile origins of the valid steps, in the order
    the grid's warps take them: block ``b``'s warp ``w`` is step
    ``b * WARPS + w``, a warp past the schedule's end returns, and lane 0's
    map gives the block coordinates and the valid flag."""
    blocks = -(-sched.steps // WARPS)
    lin = (np.arange(blocks)[:, None] * WARPS + np.arange(WARPS)[None]).reshape(-1)
    lin = lin[lin < sched.steps]
    tab = sched.prefetch
    out = sched.map(lin) if tab is None else sched.map(lin, tab)
    valid = np.broadcast_to(np.asarray(out[-1], bool), lin.shape)
    # math order (x_0, ..., x_{m-1}) -> array axes (x_{m-1}, ..., x_0)
    return np.stack([np.asarray(c, np.int64)[valid] for c in out[-2::-1]], 1)


def _digits(r: np.ndarray, base: int, count: int) -> list:
    """``count`` digits of ``r`` in ``base``, the last one fastest."""
    out = []
    for _ in range(count):
        out.insert(0, r % base)
        r = r // base
    return out


def legacy_walk(x: np.ndarray, sched, rho: int) -> None:
    """``legacy_md.cu``'s ACCUM over one launch on ``x``, in place.

    Vector path: piece ``e`` of a tile (lane ``e % 32`` takes it, in round
    ``e // (32 * UNROLL)``) is row ``e // vr`` (its digits in base rho,
    the second-to-last axis fastest) and piece ``e % vr`` of that row, its
    first element at ``first``; where the run ``n - sum(row) - first`` is
    positive the lane reads the 16 bytes there, adds one to the first
    ``run`` elements in the array's type and writes all 16 back.  Scalar
    path: element ``e`` (the last axis fastest) adds one where its
    coordinates sum below n.
    """
    m, n, size = x.ndim, x.shape[0], x.itemsize
    org = _steps(sched) * rho  # (S, m) tile origins, one warp each
    raw = x.reshape(-1).view(np.uint8)
    flat = x.reshape(-1)
    assert np.shares_memory(raw, x) and np.shares_memory(flat, x)
    if not TL.legacy_vector_access(rho, size, x.ctypes.data):
        e = np.arange(rho**m)
        g = org[:, None, :] + np.stack(_digits(e, rho, m), -1)[None]
        off = np.ravel_multi_index(tuple(np.moveaxis(g, -1, 0)), x.shape)[g.sum(-1) < n]
        assert len(np.unique(off)) == len(off)
        flat[off] = _add_one(flat[off])
        return
    ev = 16 // size
    vr = rho // ev
    pieces = rho ** (m - 1) * vr
    e = np.arange(pieces)
    lane, rnd = e % WARP, e // (WARP * UNROLL)
    assert rnd.max() < -(-pieces // (WARP * UNROLL))
    assert np.array_equal(np.sort(np.concatenate([e[lane == ln] for ln in range(WARP)])), e)
    first = (e % vr) * ev
    g = np.stack(_digits(e // vr, rho, m - 1) + [first], -1)  # (pieces, m) in the tile
    g = org[:, None, :] + g[None]  # (S, pieces, m)
    run = (n - g.sum(-1)).reshape(-1)
    start = np.ravel_multi_index(tuple(np.moveaxis(g, -1, 0)), x.shape).reshape(-1) * size
    # neighbouring lanes of a row touch neighbouring 16-byte pieces
    row_start = start.reshape(len(org), rho ** (m - 1), vr)
    assert (np.diff(row_start, axis=-1) == 16).all()
    start, run = start[run > 0], run[run > 0]
    assert ((x.ctypes.data + start) % 16 == 0).all() and len(np.unique(start)) == len(start)
    at = start[:, None] + np.arange(16)[None]
    piece = raw[at].copy().view(x.dtype)  # (P, ev) in the array's type
    keep = np.arange(ev)[None] < run[:, None]
    raw[at] = np.where(keep, _add_one(piece), piece).view(np.uint8)


def _plain(kernel, x: np.ndarray, plan, rho: int, dtype) -> np.ndarray:
    want = x.copy()
    t = _torch(want, dtype)
    for sched in plan:
        kernel.plain_(t, sched, rho)
    return want


def _check(m, n, rho, kind, split, dtype, seed):
    """The walk over every launch of the plan, bit-equal to the plain
    versions of both kernels (``accum3d`` at m=3 only)."""
    _, flat = _aligned(n**m, dtype)
    x = flat.reshape((n,) * m)
    x[...] = _values(n**m, dtype, seed).reshape(x.shape)
    plan = TL._launch_plan(m, n // rho, kind, split, "cpu")
    if split:
        assert len(plan) > 1
    before = x.copy()
    for sched in plan:
        legacy_walk(x, sched, rho)
    kernels = (TL.ACCUM3D, TL.ACCUM_MD) if m == 3 else (TL.ACCUM_MD,)
    for kernel in kernels:
        want = _plain(kernel, before, plan, rho, dtype)
        assert np.array_equal(x.view(np.uint8), want.view(np.uint8)), kernel.name
    assert not np.array_equal(x.view(np.uint8), before.view(np.uint8))


# ---------------------------------------------------------------- the rule


@pytest.mark.parametrize("dtype", policy.ACCUM_DTYPES, ids=_name)
def test_vector_access_rule(dtype):
    size = torch.empty((), dtype=dtype).element_size()
    _, aligned = _aligned(4096, dtype)
    _, misaligned = _aligned(4096, dtype, lead_bytes=size)
    assert aligned.ctypes.data % 16 == 0 and misaligned.ctypes.data % 16 != 0
    for rho in (1, 2, 3, 4, 8, 16):
        want = (rho * size) % 16 == 0
        assert TL.legacy_vector_access(rho, size, aligned.ctypes.data) is want, (rho, size)
        assert TL.legacy_vector_access(rho, size, misaligned.ctypes.data) is False, (rho, size)
        t = _torch(aligned, dtype)
        assert TL.legacy_vector_access(rho, t.element_size(), t.data_ptr()) is want


# ---------------------------------------------------------------- the kernel's walk


# (m, n, rho, kind, split) in int32: rho elements are a whole number of
# pieces at m=3 (rho 4 and 8) and m=4 (rho 4); m=5 rho=2 takes the scalar
# path in int32 and 16-byte pieces in the 8-byte types.
KIND_CASES = [
    (3, 32, 4, "hmap", None), (3, 32, 8, "bb", None), (3, 32, 4, "table", None),
    (3, 24, 4, "composite", False), (3, 24, 4, "composite", True),
    (4, 16, 4, "hmap", None), (4, 16, 4, "bb", None), (4, 16, 4, "table", None),
    (4, 12, 4, "composite", False), (4, 12, 4, "composite", True),
    (5, 8, 2, "hmap", None), (5, 8, 2, "bb", None), (5, 8, 2, "table", None),
    (5, 6, 2, "composite", False), (5, 6, 2, "composite", True),
]


@pytest.mark.parametrize("case", KIND_CASES, ids=lambda c: "-".join(map(str, c)))
def test_walk_every_kind_is_bit_equal_to_plain(case):
    m, n, rho, kind, split = case
    _check(m, n, rho, kind, split, torch.int32, seed=m * 100 + n)
    if m == 5:  # the vector path at m = 5: 16-byte rows of two 8-byte elements
        _check(m, n, rho, kind, split, torch.int64, seed=m * 100 + n + 1)


# Per dtype: m=3 rho=16 (16-byte pieces for every type, 1 to 8 a row),
# m=3 rho=4 (pieces for the 4- and 8-byte types, single elements for the
# rest), m=4 rho=2 composite split (pieces for the 8-byte types).
DTYPE_CASES = [(3, 32, 16, "hmap", None), (3, 24, 4, "composite", False),
               (4, 12, 2, "composite", True)]


@pytest.mark.parametrize("dtype", policy.ACCUM_DTYPES, ids=_name)
def test_walk_every_dtype_is_bit_equal_to_plain(dtype):
    for i, (m, n, rho, kind, split) in enumerate(DTYPE_CASES):
        _check(m, n, rho, kind, split, dtype, seed=7 * i + 3)


@pytest.mark.parametrize("case", [(3, 12, 3, "hmap", torch.int32), (3, 24, 12, "bb", torch.int32),
                                  (3, 24, 12, "table", torch.int64),
                                  (4, 12, 3, "composite", torch.int8),
                                  (3, 36, 12, "composite", torch.float32)],
                         ids=lambda c: "-".join(map(str, c[:4])) + "-" + _name(c[4]))
def test_rho_not_a_power_of_two(case):
    # rho = 3: single elements (3 elements are never 16 bytes); rho = 12:
    # 3 pieces a row of int32 or float32 and 6 of int64 (the kernel divides
    # by rho and by the pieces a row).
    m, n, rho, kind, dtype = case
    size = torch.empty((), dtype=dtype).element_size()
    assert TL.legacy_vector_access(rho, size, 0) is ((rho * size) % 16 == 0)
    _check(m, n, rho, kind, None, dtype, seed=n + rho)


@pytest.mark.parametrize("dtype", (torch.int8, torch.int32, torch.bfloat16, torch.float64),
                         ids=_name)
def test_misaligned_view_takes_the_scalar_path(dtype):
    m, n, rho = 3, 32, 16
    size = torch.empty((), dtype=dtype).element_size()
    store, flat = _aligned(n**m, dtype, lead_bytes=size)  # one element past a boundary
    x = flat.reshape((n,) * m)
    x[...] = _values(n**m, dtype, seed=5).reshape(x.shape)
    assert not TL.legacy_vector_access(rho, size, x.ctypes.data)
    assert TL.legacy_vector_access(rho, size, x.ctypes.data - size)
    outside = np.ones(store.shape, bool)
    lo = x.ctypes.data - store.ctypes.data
    outside[lo:lo + x.nbytes] = False
    kept = store[outside].copy()
    sched = TL._schedule(m, n // rho, "hmap")
    want = _plain(TL.ACCUM3D, x.copy(), [sched], rho, dtype)
    legacy_walk(x, sched, rho)
    assert np.array_equal(x.view(np.uint8), want.view(np.uint8))
    assert np.array_equal(store[outside], kept)
