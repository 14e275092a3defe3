"""The 2-D originals ``accum2d`` and ``ca2d`` on the card, held on the CPU.

``csrc/legacy2d.cu`` runs both as a warp per grid point, 8 a block at one
``wy`` (block ``(bx, wy)`` takes ``wx = 8 bx + g``).  Lanes ``g < 8`` of
every warp evaluate the map of grid point ``g``, so every warp knows by
ballots and shuffles whether the block's valid points are a prefix whose
tiles lie side by side along x (``SIDE``), a prefix stacked along y
(``STACK``, rb's folded half), or neither (``ALONE``); a block with no
valid point does nothing.

``accum2d``: where the tiles line up, the block's threads walk their
rectangle together, a thread taking pieces ``t`` and ``t + 256`` of it
(16-byte pieces where ``legacy_vector_access`` says so, else one element);
otherwise each warp walks its own tile.  Per piece the diagonal run ``r +
1 - c`` is computed once: a piece with none is not touched, and in a piece
that straddles the diagonal the cells past it are written back unchanged.

``ca2d``: where the tiles line up, the block stages one halo (a lead cell,
the tiles' cells, a trail cell a row, every cell masked at its own wrapped
position: a row's middle is one run, ``lim = R + 1``), else each warp
stages its own ``(rho+2)^2`` halo in a slice.  A lane takes ``xw`` cells of
a tile row and walks y over ``ys`` rows with the row sums before, at and
after its row in registers (the x neighbours from the lanes beside it, or
from shared memory for a row's first and last lane); the count is
``((R[y-1] + R[y]) + R[y+1]) - centre``, in an unsigned integer for
integer states and float32 for floating ones; results go out as one store
of ``xw`` cells where all lie on the triangle, else cell by cell.

Here, with numpy and no JAX call: the host rules (``legacy_vector_access``,
``CA2D.vector_access``, ``CA2D.layout``, ``CA2D.smem_bytes``), an emulation
of both walks bit-equal to ``ACCUM2D.plain_`` and ``CA2D.plain_`` for hmap,
rb and bb in every dtype, the scalar path on a view 4 bytes off a 16-byte
boundary, and the shares of the blocks' modes at the main size (nb = 1024)
that ``legacy2d.cu``'s header note states.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro_torch.kernels import legacy as TL
from repro_torch.kernels import policy

WARP, WARPS, UNROLL = 32, 8, 2
SIDE, STACK, ALONE = 0, 1, 2
NP = {torch.int8: np.int8, torch.uint8: np.uint8, torch.int16: np.int16,
      torch.int32: np.int32, torch.int64: np.int64, torch.bfloat16: ml_dtypes.bfloat16,
      torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
# Values where +1 leaves the easy range (chip_smoke.py's DTYPE_EDGES and
# LEGACY_MD_EDGES): integers at their top wrap, 16-bit floats round.
EDGES = {torch.int8: (127, 126, -128), torch.uint8: (255, 254, 0),
         torch.int16: (32767, 32766, -1), torch.int32: (2**31 - 1, -1, 7),
         torch.int64: (2**63 - 1, -1, 7), torch.bfloat16: (255, 256, 258),
         torch.float16: (2047, 2048, 2050), torch.float32: (2.0**24 - 1, 2.0**24, 3.5),
         torch.float64: (2.0**53 - 1, 2.0**53, 0.25)}


def _name(t):
    return str(t).split(".")[-1]


def _size(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _aligned(count: int, dtype, lead_bytes: int = 0):
    """``(store, view)``: a flat view of ``count`` elements starting
    ``lead_bytes`` past a 16-byte boundary, inside a larger store."""
    size = _size(dtype)
    store = np.zeros(count * size + 64, np.uint8)
    start = -store.ctypes.data % 16 + lead_bytes
    return store, store[start:start + count * size].view(NP[dtype])


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == np.dtype(ml_dtypes.bfloat16):
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def blocks(sched, warps: int = WARPS) -> dict:
    """Every block's grid points as every warp sees them
    (``legacy2d_block``): per block (row ``wy``, column ``bx``), the valid
    flags ``(B, warps)``, tile coordinates, count, mode and the first
    point's tile."""
    w, h = sched.grid
    nbx = -(-w // warps)
    wx = np.arange(nbx * warps)[None, :].repeat(h, 0)
    wy = np.arange(h)[:, None].repeat(nbx * warps, 1)
    x, y, v = sched.map(torch.from_numpy(wx), torch.from_numpy(wy))
    shape = (h * nbx, warps)
    x = np.asarray(x, np.int64).reshape(shape)
    y = np.asarray(y, np.int64).reshape(shape)
    v = (np.broadcast_to(np.asarray(v, bool), wx.shape) & (wx < w)).reshape(shape)
    g = np.arange(warps)
    cnt = v.sum(1)
    prefix = (v == (g[None] < cnt[:, None])).all(1)
    side = ((~v) | ((y == y[:, :1]) & (x == x[:, :1] + g))).all(1)
    stack = ((~v) | ((x == x[:, :1]) & (y == y[:, :1] + g))).all(1)
    mode = np.where(prefix & side, SIDE, np.where(prefix & stack & (cnt > 1), STACK, ALONE))
    keep = cnt > 0  # a block with no valid point does nothing
    return dict(valid=v[keep], x=x[keep], y=y[keep], cnt=cnt[keep], mode=mode[keep],
                blocks=int(cnt.size))


# ---------------------------------------------------------------- ACCUM


def rect_pieces(r0, c0, rows, rp, ev, nt):
    """The pieces of a rectangle as ``legacy_accum2d_rect`` hands them out:
    thread ``t`` of ``nt`` takes ``base = t, t + nt * UNROLL, ...`` and
    pieces ``base + u * nt``; returns ``(r, c)`` of each piece (each once)."""
    pieces = rows * rp
    seen = []
    for t in range(nt):
        for base in range(t, pieces, nt * UNROLL):
            seen += [base + u * nt for u in range(UNROLL) if base + u * nt < pieces]
    e = np.array(sorted(seen), np.int64)
    assert np.array_equal(e, np.arange(pieces))  # every piece by exactly one thread
    i = e // rp
    return r0 + i, c0 + (e - i * rp) * ev


def accum2d_walk(x: np.ndarray, sched, rho: int, vec: bool) -> dict:
    """``legacy2d.cu``'s ACCUM over one launch, in place on ``x``.
    Returns how many blocks walked their rectangle together and alone."""
    n, size = x.shape[0], x.itemsize
    ev = 16 // size if vec else 1
    vr = rho // ev
    b = blocks(sched)
    flat = x.reshape(-1)
    one = np.array(1).astype(x.dtype)
    touched, written = [], []
    rects = []  # (r0, c0, rows, rp, nt)
    for k in range(len(b["cnt"])):
        cnt, mode = int(b["cnt"][k]), int(b["mode"][k])
        x0, y0 = int(b["x"][k, 0]), int(b["y"][k, 0])
        if mode == SIDE:
            rects.append((y0 * rho, x0 * rho, rho, cnt * vr, WARP * WARPS, k))
        elif mode == STACK:
            rects.append((y0 * rho, x0 * rho, cnt * rho, vr, WARP * WARPS, k))
        else:
            for g in np.flatnonzero(b["valid"][k]):
                rects.append((int(b["y"][k, g]) * rho, int(b["x"][k, g]) * rho, rho, vr, WARP, k))
    for r0, c0, rows, rp, nt, k in rects:
        r, c = rect_pieces(r0, c0, rows, rp, ev, nt)
        run = r + 1 - c
        r, c, run = r[run > 0], c[run > 0], run[run > 0]  # pieces above the diagonal: untouched
        off = r * n + c
        if vec:
            assert ((x.ctypes.data + off * size) % 16 == 0).all()  # a whole 16-byte piece
        own = set(zip(b["y"][k][b["valid"][k]].tolist(), b["x"][k][b["valid"][k]].tolist()))
        for i in range(ev):
            cells = off + i
            assert set(zip((r // rho).tolist(), ((c + i) // rho).tolist())) <= own
            live = i < run
            flat[cells[live]] += one
            touched.append(cells[live])
            written.append(cells)  # read and written back, changed or not
    touched = np.concatenate(touched)
    assert len(np.unique(touched)) == len(touched)  # no cell added to twice
    written = np.concatenate(written)
    assert len(np.unique(written)) == len(written)  # no cell stored twice
    return dict(together=int((b["mode"] != ALONE).sum()), alone=int((b["mode"] == ALONE).sum()),
                touched=len(touched))


def _accum_input(n: int, dtype, seed: int, lead_bytes: int = 0):
    store, flat = _aligned(n * n, dtype, lead_bytes)
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 100, n * n).astype(np.float64 if dtype.is_floating_point else np.int64)
    edges = np.array(EDGES[dtype], v.dtype)
    v[::3] = edges[np.arange(len(v[::3])) % len(edges)]
    flat[...] = v.astype(NP[dtype])
    return store, flat.reshape(n, n)


def _accum_check(n, rho, kind, dtype, seed, lead_bytes=0):
    store, x = _accum_input(n, dtype, seed, lead_bytes)
    before = store.copy()
    want = x.copy()
    sched = TL._schedule(2, n // rho, kind)
    TL.ACCUM2D.plain_(_torch(want), sched, rho)
    vec = TL.legacy_vector_access(rho, x.itemsize, x.ctypes.data)
    assert vec is TL.legacy_vector_access(rho, x.itemsize, _torch(x).data_ptr())
    modes = accum2d_walk(x, sched, rho, vec)
    assert np.array_equal(x.view(np.uint8), want.view(np.uint8))
    start = x.ctypes.data - store.ctypes.data
    assert np.array_equal(store[:start], before[:start])  # the neighbours are unchanged
    assert np.array_equal(store[start + x.nbytes:], before[start + x.nbytes:])
    return vec, modes


# ---------------------------------------------------------------- CA


class _Count:
    """The count's type: an unsigned integer of at least 32 bits for an
    integer state (the state's unsigned type widened), float32 for a
    floating one."""

    def __init__(self, dtype: np.dtype):
        self.t = dtype
        self.float = dtype.kind == "f" or dtype == np.dtype(ml_dtypes.bfloat16)
        if not self.float:
            self.u = UNSIGNED[dtype.itemsize]
            self.a = np.uint64 if dtype.itemsize == 8 else np.uint32

    def widen(self, v):
        if self.float:
            return v.astype(np.float32)
        return v.view(self.u).astype(self.a)

    def is_(self, a, v: int):
        if self.float:
            return a == np.float32(v)
        return a.astype(self.u) == np.array(v).astype(self.t).view(self.u)


def ca_stage(inp: np.ndarray, r0, c0, rows: int, cells: int, rs: int, pe: int, nt: int,
             length: int) -> np.ndarray:
    """``(S, length)`` halos as ``legacy_ca2d_stage`` fills them over
    poisoned memory (a cell the walk reads but staging never wrote would
    show): ``rows`` rows from array row ``r0`` (wrapped), each the wrapped
    lead cell at ``pe - 1``, ``cells`` cells from column ``c0`` at ``pe``,
    the wrapped trail cell after them; every cell masked by ``col <=
    row`` at its wrapped position."""
    n, size = inp.shape[0], inp.itemsize
    parts = cells // pe + 2
    # a thread's (row, part) advances by nt parts without a division
    taken = np.zeros(rows * parts, int)
    for t in range(min(nt, rows * parts)):
        dr, dp = divmod(nt, parts)
        hr, p = divmod(t, parts)
        while hr < rows:
            taken[hr * parts + p] += 1
            p, hr = p + dp, hr + dr
            if p >= parts:
                p, hr = p - parts, hr + 1
    assert (taken == 1).all()
    assert (rows - 1) * rs + pe + cells + 1 <= length
    flat = inp.reshape(-1)
    zero = np.zeros((), inp.dtype)
    halo = np.full((len(r0), length), np.array(5).astype(inp.dtype), inp.dtype)
    for hr in range(rows):
        R = (r0 + hr) % n
        for p in range(parts):
            if p in (0, parts - 1):  # a wrapped edge cell, a scalar
                C = (c0 - 1) % n if p == 0 else (c0 + cells) % n
                at = hr * rs + (pe - 1 if p == 0 else pe + cells)
                halo[:, at] = np.where(C <= R, flat[R * n + C], zero)
                continue
            xs = c0 + (p - 1) * pe
            cnt = np.clip(R + 1 - xs, 0, pe)  # the run lim = R + 1
            if pe > 1:  # a 16-byte piece: both ends on 16-byte boundaries
                assert ((hr * rs + p * pe) * size) % 16 == 0
                assert (((R * n + xs) * size)[cnt > 0] % 16 == 0).all()
            for i in range(pe):
                live = i < cnt
                src = np.where(live, R * n + xs + i, 0)
                halo[:, hr * rs + p * pe + i] = np.where(live, flat[src], zero)
    return halo


def ca_count(out: np.ndarray, halo: np.ndarray, at: np.ndarray, gy0: np.ndarray,
             gx0: np.ndarray, rho: int, lay: dict, rs: int, written: list) -> None:
    """One warp's count and rule for each of ``len(at)`` tiles, the
    tile's first cell at element ``at`` of its row 0 of ``halo`` (tile row
    -1), rows ``rs`` apart; the results into ``out``."""
    n, size = out.shape[0], out.itemsize
    xw, ys = lay["xw"], lay["ys"]
    cnt = _Count(out.dtype)
    vr = rho // xw
    lr, chunks = min(vr, WARP), -(-vr // WARP)
    groups = WARP // lr
    lane = np.arange(WARP)
    gi, li = lane // lr, lane % lr
    items = rho // ys * chunks
    one, zero = np.array(1).astype(out.dtype), np.array(0).astype(out.dtype)
    flat_out = out.reshape(-1)
    tiles = np.arange(len(at))[:, None, None]
    for base in range(0, items, groups):
        r = base + gi
        act = (gi < groups) & (r < items)
        r = np.where(act, r, 0)
        seg, c = r // chunks, r % chunks
        xp = c * lr + li
        act &= xp < vr
        xp = np.where(act, xp, 0)
        lsm, rsm = li == 0, (li == lr - 1) | (xp == vr - 1)
        yb = seg * ys
        col = at[:, None] + (yb * rs + xp * xw)[None]  # (S, 32)

        def row(pos):
            cells = halo[tiles, pos[:, :, None] + np.arange(xw)[None, None, :]]  # (S, 32, xw)
            h = cnt.widen(cells)
            up = np.concatenate([h[:, :1, -1], h[:, :-1, -1]], 1)  # __shfl_up_sync(.., 1)
            down = np.concatenate([h[:, 1:, 0], h[:, -1:, 0]], 1)  # __shfl_down_sync(.., 1)
            left = np.where(lsm[None], cnt.widen(halo[tiles[:, :, 0], pos - 1]), up)
            right = np.where(rsm[None], cnt.widen(halo[tiles[:, :, 0], pos + xw]), down)
            sums = np.empty_like(h)
            for i in range(xw):
                a = left if i == 0 else h[:, :, i - 1]
                b = right if i == xw - 1 else h[:, :, i + 1]
                sums[:, :, i] = (a + h[:, :, i]) + b
            return sums, cells

        below, _ = row(col)
        at_, cen = row(col + rs)
        gx = gx0[:, None] + xp * xw
        for dy in range(ys):
            above, nxt = row(col + (dy + 2) * rs)
            gy = gy0[:, None] + yb + dy
            run = gy + 1 - gx  # (S, 32)
            neigh = ((below + at_) + above) - cnt.widen(cen)
            three = cnt.is_(neigh, 3)
            alive = ((cen == zero) & three) | ((cen == one) & (cnt.is_(neigh, 2) | three))
            res = np.where(alive, one, zero)
            off = gy * n + gx
            store = act[None] & (run > 0)
            if xw > 1:  # a whole store of xw cells is aligned to its size
                full = store & (run >= xw)
                assert ((out.ctypes.data + off * size)[full] % (xw * size) == 0).all()
            for i in range(xw):
                keep = store & (i < run)
                flat_out[off[keep] + i] = res[:, :, i][keep]
                written.append(off[keep] + i)
            below, at_, cen = at_, above, nxt


def ca2d_walk(inp: np.ndarray, out: np.ndarray, sched, rho: int, vec: bool) -> dict:
    """``legacy2d.cu``'s CA over one launch: ``out`` (a copy of ``inp``)
    gets the stepped triangle cells of every visited tile.  Returns how
    many blocks staged one halo side by side, stacked, and a slice a warp."""
    n, size = inp.shape[0], inp.itemsize
    lay = TL.CA2D.layout(rho, size, vec)
    pe, warps, rs, rs1, ys = lay["pe"], lay["warps"], lay["rs"], lay["rs1"], lay["ys"]
    assert lay["smem"] and rho % ys == 0 and rho % lay["xw"] == 0
    assert lay["slots"] >= 1 and lay["slots"] * lay["slice"] * size <= lay["smem"]
    b = blocks(sched, warps)
    length = lay["smem"] // size
    written = []
    for mode, stride in ((SIDE, rs), (STACK, rs1)):
        for cnt in range(1, warps + 1):
            sel = (b["mode"] == mode) & (b["cnt"] == cnt)
            if not sel.any():
                continue
            y0, x0 = b["y"][sel, 0], b["x"][sel, 0]
            rows, cells = (cnt * rho + 2, rho) if mode == STACK else (rho + 2, cnt * rho)
            assert rows <= (warps * rho + 2 if mode == STACK else rho + 2)
            halo = ca_stage(inp, y0 * rho - 1, x0 * rho, rows, cells, stride, pe,
                            WARP * warps, length)
            g = np.arange(cnt)
            halo = np.repeat(halo, cnt, 0)  # each warp g < cnt reads the block's halo
            at = np.tile((g * rho * stride if mode == STACK else g * rho) + pe, int(sel.sum()))
            ty = b["y"][sel][:, :cnt].reshape(-1)
            tx = b["x"][sel][:, :cnt].reshape(-1)
            ca_count(out, halo, at, ty * rho, tx * rho, rho, lay, stride, written)
    alone = b["mode"] == ALONE
    if alone.any():  # a slice a warp, `slots` warps a round
        valid = b["valid"][alone]
        ty, tx = b["y"][alone][valid], b["x"][alone][valid]
        halo = ca_stage(inp, ty * rho - 1, tx * rho, rho + 2, rho, rs1, pe, WARP, lay["slice"])
        ca_count(out, halo, np.full(len(ty), pe), ty * rho, tx * rho, rho, lay, rs1, written)
    written = np.concatenate(written)
    assert len(np.unique(written)) == len(written)  # no cell written twice
    r, c = np.indices((rho, rho)).reshape(2, -1)
    ty, tx = b["y"][b["valid"]], b["x"][b["valid"]]
    R, C = ty[:, None] * rho + r, tx[:, None] * rho + c
    want = (R * n + C)[C <= R]
    assert np.array_equal(np.sort(written), np.sort(want))  # every triangle cell of every tile
    return dict(side=int((b["mode"] == SIDE).sum()), stack=int((b["mode"] == STACK).sum()),
                alone=int(alone.sum()))


def _state(n: int, dtype, seed: int, anyval: bool = False) -> np.ndarray:
    """A state over the whole square (live cells above the triangle too):
    0/1 of density 0.35, or any value of the integer type's range."""
    rng = np.random.default_rng(seed)
    if anyval:
        info = np.iinfo(NP[dtype])
        v = rng.integers(info.min, info.max, (n, n), endpoint=True, dtype=np.int64)
        # half the cells 0/1, so that some counts wrap to 2 or 3
        v = np.where(rng.random(v.shape) < 0.5, rng.integers(0, 2, v.shape), v)
        return v.astype(NP[dtype])
    return (rng.random((n, n)) < 0.35).astype(NP[dtype])


def _ca_check(n, rho, kind, dtype, seed, anyval=False, lead_bytes=0):
    """The walk on a fresh state, bit-equal to the plain version; returns
    the access path and the blocks' modes."""
    _, flat = _aligned(n * n, dtype, lead_bytes)
    inp = flat.reshape(n, n)
    inp[...] = _state(n, dtype, seed, anyval)
    out_store, out_flat = _aligned(n * n, dtype, lead_bytes)
    out = out_flat.reshape(n, n)
    out[...] = inp
    before = out_store.copy()
    size = inp.itemsize
    vec = TL.CA2D.vector_access(rho, size, out.ctypes.data, inp.ctypes.data)
    t_in = _torch(inp)
    assert vec is TL.CA2D.vector_access(rho, t_in.element_size(), out.ctypes.data,
                                        t_in.data_ptr())
    sched = TL._schedule(2, n // rho, kind)
    modes = ca2d_walk(inp, out, sched, rho, vec)
    want = inp.copy()
    TL.CA2D.plain_(_torch(want), t_in, sched, rho)
    assert np.array_equal(out.view(np.uint8), want.view(np.uint8))
    assert not np.array_equal(out.view(np.uint8), inp.view(np.uint8))
    start = out.ctypes.data - out_store.ctypes.data
    assert np.array_equal(out_store[:start], before[:start])  # the neighbours are unchanged
    assert np.array_equal(out_store[start + out.nbytes:], before[start + out.nbytes:])
    return vec, modes


# ---------------------------------------------------------------- the rules

RHOS = (1, 2, 3, 4, 8, 16, 32)


@pytest.mark.parametrize("dtype", policy.ACCUM_DTYPES, ids=_name)
def test_accum_vector_rule(dtype):
    size = _size(dtype)
    for rho in RHOS:
        assert TL.legacy_vector_access(rho, size, 0) is ((rho * size) % 16 == 0)
        assert TL.legacy_vector_access(rho, size, 32) is ((rho * size) % 16 == 0)
        assert not TL.legacy_vector_access(rho, size, 4)  # a view off a 16-byte boundary


@pytest.mark.parametrize("dtype", policy.CA_DTYPES, ids=_name)
def test_ca_layout_rule(dtype):
    size = _size(dtype)
    for rho in RHOS:
        for vec in (False, True):
            if vec and (rho * size) % 16:
                continue
            lay = TL.CA2D.layout(rho, size, vec)
            pe, xw, rs, rs1, w = lay["pe"], lay["xw"], lay["rs"], lay["rs1"], lay["warps"]
            assert pe == (16 // size if vec else 1) and rho % xw == 0 and (pe % xw == 0)
            assert xw == ((2 if size == 8 else 4) if vec else 1)
            assert rs1 >= rho + 2 * pe and rs >= w * rho + 2 * pe and rs % pe == rs1 % pe == 0
            assert rho % lay["ys"] == 0 and 1 <= w <= TL.CA2D.WARPS
            assert lay["slice"] * size % 16 == 0 and lay["slice"] >= rs1 * (rho + 2)
            assert lay["smem"] >= rs * (rho + 2) * size  # side by side
            assert lay["smem"] >= rs1 * (w * rho + 2) * size  # stacked
            assert lay["smem"] >= lay["slots"] * lay["slice"] * size and 1 <= lay["slots"] <= w
            assert w == 1 or lay["smem"] <= TL.CA2D.BUDGET
            # as few segments as keep the warp's lanes busy
            vr = rho // xw
            lr, chunks = min(vr, WARP), -(-vr // WARP)
            segs = rho // lay["ys"]
            assert segs * chunks >= WARP // lr or segs == rho
            assert all(rho % s or s * chunks < WARP // lr for s in range(1, segs))
        # the least block (single cells) is what the entry point checks, and
        # it refuses no more than a (rho+2)^2 halo of single cells did
        least = TL.CA2D.smem_bytes(rho, size)
        assert least == TL.CA2D.layout(rho, size, False)["slice"] * size
        assert (least <= policy.SMEM_LIMIT) is (size * (rho + 2) ** 2 <= policy.SMEM_LIMIT)
    # the main case: 8 warps, side-by-side rows of 128 cells and two
    # pieces, slices of 6 pieces a row, 2 rows a lane group
    lay = TL.CA2D.layout(16, 4, True)
    assert (lay["warps"], lay["rs"], lay["rs1"], lay["ys"], lay["slots"]) == (8, 136, 24, 2, 8)
    # the budget cuts the warps at rho 32 int64 and rho 64 int32
    assert TL.CA2D.layout(32, 8, True)["warps"] == 6
    assert TL.CA2D.layout(64, 4, True)["warps"] == 3


def test_ca_smem_refusals_do_not_grow():
    # the entry point's check (single cells, no table) at the edge of a block
    for size in (1, 2, 4, 8):
        last = max(r for r in range(1, 600) if size * (r + 2) ** 2 <= policy.SMEM_LIMIT)
        assert TL.CA2D.smem_bytes(last, size) <= policy.SMEM_LIMIT
        assert TL.CA2D.smem_bytes(last + 1, size) > policy.SMEM_LIMIT


def test_ca_vector_rule_needs_both_buffers_aligned():
    assert TL.CA2D.vector_access(16, 4, 0, 16)
    assert not TL.CA2D.vector_access(16, 4, 4, 16)
    assert not TL.CA2D.vector_access(16, 4, 16, 4)
    assert not TL.CA2D.vector_access(2, 4, 0, 0)  # 8 bytes a row: single cells
    assert TL.CA2D.vector_access(2, 8, 0, 0)
    assert not TL.CA2D.vector_access(168, 8, 0, 0)  # the padded slice would not fit
    assert TL.CA2D.smem_bytes(168, 8) <= policy.SMEM_LIMIT  # single cells still fit


# ---------------------------------------------------------------- the walks


# (n, rho, kind): 16-byte pieces at rho 4, 8 and 16 in int32, single cells
# at rho 1, 2 and 3 (rb and bb at a tile count that is no power of two)
KIND_CASES = [(128, 4, "hmap"), (128, 4, "rb"), (128, 4, "bb"), (128, 8, "hmap"),
              (96, 8, "rb"), (64, 16, "bb"), (64, 2, "hmap"), (36, 3, "rb"), (24, 1, "bb"),
              (64, 16, "hmap")]


@pytest.mark.parametrize("case", KIND_CASES, ids=lambda c: "-".join(map(str, c)))
def test_accum_walk_every_kind_is_bit_equal_to_plain(case):
    n, rho, kind = case
    vec, modes = _accum_check(n, rho, kind, torch.int32, seed=n + rho)
    assert vec is ((rho * 4) % 16 == 0)
    assert modes["together"] > 0
    if kind != "bb":
        assert modes["alone"] > 0  # hmap's first rows, the fold's edge


@pytest.mark.parametrize("dtype", policy.ACCUM_DTYPES, ids=_name)
def test_accum_walk_every_dtype_at_its_edges(dtype):
    # rho 4: pieces for the 4- and 8-byte types; rho 16: for every type
    for kind in ("hmap", "rb", "bb"):
        for rho in (4, 16):
            vec, _ = _accum_check(64, rho, kind, dtype, seed=rho)
            assert vec is ((rho * _size(dtype)) % 16 == 0)


def test_accum_walk_on_a_misaligned_view_takes_single_elements():
    vec, _ = _accum_check(64, 8, "hmap", torch.int32, seed=5, lead_bytes=4)
    assert not vec


@pytest.mark.parametrize("case", KIND_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ca_walk_every_kind_is_bit_equal_to_plain(case):
    n, rho, kind = case
    vec, modes = _ca_check(n, rho, kind, torch.int32, seed=n * 10 + rho)
    assert vec is ((rho * 4) % 16 == 0)
    assert modes["side"] > 0
    if kind == "rb" and n // rho >= 16:
        assert modes["stack"] > 0  # the folded half
    if kind != "bb":
        assert modes["alone"] > 0


@pytest.mark.parametrize("dtype", policy.CA_DTYPES, ids=_name)
def test_ca_walk_every_dtype_on_01_states(dtype):
    # rho 8: pieces for the 2-, 4- and 8-byte types, single cells for the
    # 1-byte ones; rho 16: pieces for every type
    size = _size(dtype)
    assert _ca_check(64, 8, "hmap", dtype, seed=3)[0] is ((8 * size) % 16 == 0)
    assert _ca_check(128, 16, "rb", dtype, seed=4)[0]


@pytest.mark.parametrize("dtype", (torch.int8, torch.int16, torch.int32, torch.int64), ids=_name)
@pytest.mark.parametrize("rho", (2, 8, 16))
def test_ca_walk_states_of_any_value_wrap(dtype, rho):
    _ca_check(64, rho, "hmap", dtype, seed=rho, anyval=True)


def test_ca_walk_where_the_budget_cuts_the_warps():
    # rho 32 int64 (6 warps a block), rho 64 int32 (3) and int64 (1, one
    # slice a block)
    assert TL.CA2D.layout(64, 8, True)["warps"] == TL.CA2D.layout(64, 8, True)["slots"] == 1
    assert _ca_check(128, 32, "rb", torch.int64, seed=7)[0]
    assert _ca_check(256, 64, "hmap", torch.int32, seed=8)[0]
    assert _ca_check(256, 64, "rb", torch.int64, seed=10)[0]


def test_ca_walk_on_misaligned_buffers_takes_single_cells():
    assert not _ca_check(64, 8, "bb", torch.int32, seed=9, lead_bytes=4)[0]


def test_ca_wrapped_halo_reaches_the_corner_tiles():
    # two tiles a side: every halo wraps, the corner cells masked at their
    # wrapped positions (row -1 -> n-1 keeps every column, row n -> 0 only
    # column 0); all-live states make each masked cell count
    n, rho = 32, 16
    for kind in ("hmap", "rb", "bb"):
        for seed in (1, 2):
            _ca_check(n, rho, kind, torch.int32, seed=seed)
    _, flat = _aligned(n * n, torch.int32)
    inp = flat.reshape(n, n)
    inp[...] = 1
    out = inp.copy()
    sched = TL._schedule(2, n // rho, "hmap")
    ca2d_walk(inp, out, sched, rho, True)
    want = inp.copy()
    TL.CA2D.plain_(_torch(want), _torch(inp), sched, rho)
    # every triangle cell sees 4 to 8 live cells (cell (0, 0): 3 in row n-1,
    # none of row 0's wrapped column n-1, 2 in row 1) and dies; the cells
    # above the triangle keep their input
    tri = np.tril(np.ones((n, n), bool))
    assert np.array_equal(out, want) and (want[tri] == 0).all() and (want[~tri] == 1).all()


# ---------------------------------------------------------------- the shares


def test_block_modes_at_the_main_size():
    # m=2 n=16384 rho=16 (nb 1024), the card's main case: the shares of
    # valid grid points in blocks whose tiles lie side by side, stacked or
    # neither, as legacy2d.cu's header note states them
    shares = {}
    for kind in ("hmap", "rb", "bb"):
        b = blocks(TL._schedule(2, 1024, kind))
        pts = b["cnt"].sum()
        shares[kind] = [round(float(b["cnt"][b["mode"] == m].sum() / pts), 4)
                        for m in (SIDE, STACK, ALONE)]
        assert pts == 524800
        if kind == "bb":  # half the blocks hold no valid point and return whole
            assert (b["blocks"], len(b["cnt"])) == (131072, 66048)
    assert shares == {"hmap": [0.9912, 0.0, 0.0088], "rb": [0.7463, 0.2468, 0.0068],
                      "bb": [1.0, 0.0, 0.0]}
