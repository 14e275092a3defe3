"""The 2-D original EDM (``edm2d``) on the card, held on the CPU.

``csrc/legacy2d.cu`` runs ``edm2d`` over the paper's ``(w, h)`` grid with
a run of ``tiles`` grid points a block: block ``(bx, wy)`` takes ``wx =
bx * tiles + g``.  Warp 0 maps them, lane ``2g`` holding point g's row
block and lane ``2g + 1`` its column block (-1 for none); shuffles and a
ballot find each block's first lane, and a pass takes the longest run of
points whose distinct blocks fit the slots.  Each distinct block is staged
once (point ``q`` at ``q ld + 4 (q // 4)`` floats of its slot, ``ld / 4``
odd, the pad ``k >= d`` zero), then a thread computes a ``ROWS x COLS``
block of one tile's cells, rows ``r + tr i`` and columns ``4 c + j``:
``t = p_r[k] - p_c[k]`` rounded, ``acc = fma(t, t, acc)`` over ``k = 0 ..
d-1`` in order, ``sqrt`` rounded, and stores the cells with ``col <= row``
inside the tile, a row's four as one store where all four are.

Here, with numpy and no JAX call: an emulation of that walk (the blocks'
grid points, the dedup and its passes, the staging layout, each thread's
register block, the diagonal mask) bit-equal to a float32 numpy
emulation of the kernel's summation order over the whole triangle, and
within ``1e-5 + 1e-5 * max|want|`` of ``EDM2D.plain_``, for hmap, rb and bb
at rho 1, 3, 8 and 16 and d = 3, 5 and 64; the exact fused multiply-add
the emulations use, against rational arithmetic.
"""

import fractions

import ml_dtypes
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro_torch.kernels import legacy as TL
from repro_torch.kernels import policy

WARP = 32


def fmaf_sq(t: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """``fmaf(t, t, acc)`` in float32, rounded once to nearest even.

    ``t * t`` is exact in float64 (48 bits); the sum is rounded to float64
    and its error kept exactly (TwoSum); the float32 rounding of the
    float64 sum is then correct except where that sum lies on a float32
    midpoint while the exact sum does not, which the error's sign
    settles."""
    p = t.astype(np.float64) ** 2
    a = acc.astype(np.float64)
    s = p + a
    bb = s - p
    e = (p - (s - bb)) + (a - bb)
    r = s.astype(np.float32)
    diff = s - r.astype(np.float64)
    nb = np.nextafter(r, np.where(diff > 0, np.float32(np.inf), np.float32(-np.inf)))
    half = (nb.astype(np.float64) - r.astype(np.float64)) / 2
    fix = (diff != 0) & (diff == half) & (e != 0) & (np.sign(e) == np.sign(diff))
    return np.where(fix, nb, r)


def _round32(q: fractions.Fraction) -> np.float32:
    """A rational rounded to float32, nearest with ties to even."""
    r = np.float32(float(q))
    best = None
    for c in (np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))):
        err = abs(fractions.Fraction(float(c)) - q)
        even = int(np.array(c).view(np.uint32)) % 2 == 0
        if best is None or err < best[0] or (err == best[0] and even):
            best = (err, c)
    return best[1]


def test_fmaf_emulation_is_exact():
    rng = np.random.default_rng(0)
    t = (rng.standard_normal(3000) * 2.0 ** rng.integers(-8, 8, 3000)).astype(np.float32)
    acc = np.abs(rng.standard_normal(3000) * 2.0 ** rng.integers(-4, 12, 3000)).astype(np.float32)
    # sums on a float32 midpoint after a float64 rounding: acc = 1, t*t just
    # above 2^-24 (half an ulp of 1) by less than a float64 ulp of the sum
    t[:8] = np.float32(2.0 ** -12) * (1 + np.arange(8, dtype=np.float32) * 2.0 ** -23)
    acc[:8] = 1
    got = fmaf_sq(t, acc)
    for i in range(len(t)):
        q = fractions.Fraction(float(t[i])) ** 2 + fractions.Fraction(float(acc[i]))
        assert got[i] == _round32(q), (t[i], acc[i])


def direct(p32: np.ndarray, cast) -> np.ndarray:
    """The kernel's arithmetic per cell over the whole lower triangle, in
    k order: the reference the walk must match bit for bit."""
    n, d = p32.shape
    acc = np.zeros((n, n), np.float32)
    for k in range(d):
        t = p32[:, None, k] - p32[None, :, k]  # float32, rounded once
        acc = fmaf_sq(t, acc)
    return np.tril(cast(np.sqrt(acc)))


def _first_lanes(ids: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Per block and lane: the first lane in [lo, lane] holding the same
    block (the kernel's shuffle loop)."""
    first = np.broadcast_to(np.arange(WARP), ids.shape).copy()
    for u in range(WARP):
        hit = (first == np.arange(WARP)) & (u >= lo[:, None]) & (u < np.arange(WARP)) & (
            ids[:, u, None] == ids)
        first[hit] = u
    return first


def edm2d_walk(p32: np.ndarray, out: np.ndarray, sched, rho: int, vec: bool, cast) -> int:
    """``legacy2d.cu``'s EDM over one launch into the zero-seeded ``out``;
    returns the number of passes beyond one a block."""
    n, d = p32.shape
    w = sched.grid[0]
    h = sched.steps // w
    lay = TL.EDM2D.layout(rho, d, w)
    tr, tc, ld, pts, tiles, slots = (lay[k] for k in ("tr", "tc", "ld", "pts", "tiles", "slots"))
    R, C = TL.EDM2D.ROWS, TL.EDM2D.COLS
    assert lay["smem"] and (ld // 4) % 2 == 1 and ld >= d and pts >= rho
    assert lay["threads"] % WARP == 0 and 64 + slots + 2 <= TL.EDM2D.TABLE
    assert lay["smem"] == 4 * (pts * ld + pts) * slots + 4 * TL.EDM2D.TABLE
    assert C == 4 and pts % 4 == 0
    ss = pts * ld + pts  # floats a slot
    at = np.arange(pts) * ld + (np.arange(pts) // 4) * 4  # each point's first float
    # a quarter warp's 16-byte units (r in {0, 1}, c in 0..3): distinct banks
    units_r = at[np.minimum(np.arange(2), pts - 1)] // 4
    units_c = at[4 * np.arange(min(4, tc))] // 4
    assert len(set(units_r % 8)) == len(units_r) and len(set(units_c % 8)) == len(units_c)
    k4 = -(-d // 4) * 4
    bx = np.arange(-(-w // tiles))
    lane = np.arange(WARP)
    g_of = lane >> 1
    extra = 0
    tiles_a, tiles_c, origins = [], [], []  # every computed tile's staged points
    for wy in range(h):  # its passes: the points' runs whose blocks fit the slots
        wx = bx[:, None] * tiles + g_of[None]  # (B, 32)
        live = (g_of[None] < tiles) & (wx < w)
        xs, ys, valid = sched.map(torch.as_tensor(np.where(live, wx, 0)),
                                  torch.full(wx.shape, wy))
        xs, ys = np.asarray(xs), np.asarray(ys)
        valid = np.broadcast_to(np.asarray(valid, bool), wx.shape) & live
        ids = np.where(valid, np.where(lane % 2 == 1, xs, ys), -1)
        g0 = np.zeros(len(bx), np.int64)
        while (g0 < tiles).any():
            go = g0 < tiles
            first = _first_lanes(ids, 2 * g0)  # __match_any_sync, from lane 2 g0
            mine = (lane[None] >= 2 * g0[:, None]) & (ids >= 0)
            firsts = mine & (first == lane)
            upto = np.cumsum(firsts, 1)  # popc of the firsts at lanes <= lane
            fit = (lane % 2 == 1) & (lane >= 2 * g0[:, None]) & (g_of < tiles) & (upto <= slots)
            assert fit[np.arange(len(bx)), np.minimum(2 * g0 + 1, WARP - 1)][go].all()
            g1 = np.where(fit.any(1), (WARP - np.argmax(fit[:, ::-1], 1)) // 2, 0)
            taken = firsts & (lane[None] < 2 * g1[:, None])
            mine_slot = np.cumsum(taken, 1) - taken  # popc below the lane
            slot = np.take_along_axis(mine_slot, first, 1)
            assert (taken.sum(1) <= slots).all()
            extra += int(((g1 < tiles) & go).sum())
            for b in np.nonzero(go)[0]:
                # the slots: poison, the pad k >= d zero, each taken block
                # staged once, point q at at[q]
                smem = np.full((slots, ss), 7.0, np.float32)
                for k in range(d, k4):
                    smem[:, at + k] = 0
                for u in np.nonzero(taken[b])[0]:
                    blk = ids[b, u]
                    if vec:  # 16-byte copies: both ends on 16-byte boundaries
                        assert (blk * rho * d * 4) % 16 == 0 and (at * 4 % 16 == 0).all()
                    smem[slot[b, u], at[:rho, None] + np.arange(d)] = p32[blk * rho:(blk + 1) * rho]
                for g in range(g0[b], g1[b]):
                    if ids[b, 2 * g] >= 0:
                        tiles_a.append(smem[slot[b, 2 * g], at[:, None] + np.arange(k4)])
                        tiles_c.append(smem[slot[b, 2 * g + 1], at[:, None] + np.arange(k4)])
                        origins.append((ids[b, 2 * g], ids[b, 2 * g + 1]))
            g0 = np.where(go, g1, g0)
    # each tile's threads: thread (r, c) holds rows r + tr i, columns 4 c + j
    a, c = np.stack(tiles_a), np.stack(tiles_c)  # (T, pts, k4)
    r_idx = np.arange(tr)[:, None] + tr * np.arange(R)[None]  # (tr, R)
    c_idx = C * np.arange(tc)[:, None] + np.arange(C)[None]  # (tc, C)
    acc = np.zeros((len(a), tr, tc, R, C), np.float32)
    for k in range(k4):
        t = a[:, r_idx, k][:, :, None, :, None] - c[:, c_idx, k][:, None, :, None, :]
        acc = fmaf_sq(t, acc)
    res = cast(np.sqrt(acc))
    yb, xb = (np.array(v)[:, None, None, None, None] for v in zip(*origins))
    rows = r_idx[None, :, None, :, None] + 0 * acc.astype(np.int64)
    cols = c_idx[None, None, :, None, :] + 0 * acc.astype(np.int64)
    keep = (rows < rho) & (cols < rho) & (xb * rho + cols <= yb * rho + rows)
    # a row's four cells as one store: all four kept, 4 * itemsize aligned
    whole = keep.all(-1) & (rho % 4 == 0)
    first = ((yb * rho + rows) * n + xb * rho + cols)[..., 0] * out.itemsize
    assert (first[whole] % (4 * out.itemsize) == 0).all()
    R_, C_ = (yb * rho + rows)[keep], (xb * rho + cols)[keep]
    out[R_, C_] = res[keep]
    written = np.zeros((n, n), np.int64)
    np.add.at(written, (R_, C_), 1)
    assert (written == np.tril(np.ones((n, n), np.int64))).all()  # each cell once
    return extra


CASTS = {torch.float32: lambda v: v.astype(np.float32),
         torch.float64: lambda v: v.astype(np.float64),
         torch.float16: lambda v: v.astype(np.float16),
         torch.bfloat16: lambda v: v.astype(ml_dtypes.bfloat16)}


def _check(n, rho, d, kind, dtype=torch.float32, seed=0, lead_bytes=0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.standard_normal((n, d))).to(dtype)
    pts[1::4] = pts[::4][:len(pts[1::4])]  # exact duplicates: zero distances
    store = np.zeros(n * d + 16, np.float32)
    start = (-store.ctypes.data % 16 + lead_bytes) // 4
    p32 = store[start:start + n * d].reshape(n, d)
    p32[...] = pts.to(torch.float32).numpy()  # the kernel's float32 copy
    vec = TL.legacy_vector_access(d, 4, p32.ctypes.data)
    assert vec is (d % 4 == 0 and lead_bytes == 0)
    sched = TL._schedule(2, n // rho, kind)
    cast = CASTS[dtype]
    out = np.zeros((n, n), cast(np.zeros(1)).dtype)
    extra = edm2d_walk(p32, out, sched, rho, vec, cast)
    ref = direct(p32, cast)
    assert np.array_equal(out.view(np.uint8), ref.view(np.uint8))
    want = torch.zeros((n, n), dtype=dtype)
    TL.EDM2D.plain_(want, pts, sched, rho)
    want = want.to(torch.float64).numpy()
    got = out.astype(np.float64)
    tol = 1e-5 + 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    return extra


# (n, rho): tiles of 1, 3, 8 and 16 on small sides; rho 3 is not a
# multiple of a thread's 4 x 4 cells, rho 1 gives one cell a thread and
# 16 grid points a block, whose hmap rows wy < 16 take several passes.
SIZES = [(32, 1), (24, 3), (64, 8), (64, 16)]


@pytest.mark.parametrize("kind", ("hmap", "rb", "bb"))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"n{s[0]}-rho{s[1]}")
def test_walk_is_bit_equal_to_its_summation_order(size, kind):
    n, rho = size
    extra = 0
    for d in (3, 5, 64):
        extra += _check(n, rho, d, kind, seed=n + rho + d)
    if rho == 1 and kind == "hmap":
        assert extra > 0  # the passes were exercised


@pytest.mark.parametrize("dtype", (torch.float16, torch.bfloat16, torch.float64),
                         ids=lambda t: str(t).split(".")[-1])
def test_walk_output_types(dtype):
    # points and output in the type, arithmetic in float32 on the points'
    # float32 copy
    _check(32, 8, 5, "hmap", dtype=dtype, seed=3)


def test_walk_off_16_byte_pieces():
    # points one float past a 16-byte boundary: single-float copies
    _check(32, 8, 64, "rb", seed=4, lead_bytes=4)


def test_layout_rule():
    for rho in (1, 2, 3, 8, 16, 32, 64):
        for d in (1, 3, 4, 5, 64, 100, 1000):
            for w in (1, 2, 8, 512, 32768):
                lay = TL.EDM2D.layout(rho, d, w)
                assert lay["tiles"] <= min(w, TL.EDM2D.MAX_TILES)
                assert lay["slots"] == (2 if lay["tiles"] == 1 else lay["tiles"] + 2)
                assert lay["smem"] <= policy.SMEM_LIMIT
                assert 32 <= lay["threads"] <= TL.EDM2D.THREADS
                assert lay["smem"] == 0 or lay["smem"] >= TL.EDM2D.smem_bytes(rho, d)
                assert (lay["smem"] > 0) is (TL.EDM2D.smem_bytes(rho, d) <= policy.SMEM_LIMIT)
    # the main case: 8 grid points a block over 10 slots, 4 x 4 cells a thread
    lay = TL.EDM2D.layout(16, 64, 512)
    assert (lay["tiles"], lay["slots"], lay["threads"], lay["smem"]) == (8, 10, 128, 44544)
