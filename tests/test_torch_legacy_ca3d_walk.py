"""The m=3 original CA (``ca3d``) on the card, held on the CPU.

``csrc/legacy_md.cu`` runs ``ca3d`` as one warp per schedule step, up to
eight a block; lane 0 evaluates the map and an invalid step's warp
returns.  Each warp stages its step's ``(rho+2)^3`` halo as ``(rho+2)^2``
rows along x in its own slice of shared memory: a lead piece, the tile
row and a trail piece, ``pe`` cells each (16-byte pieces where
``CA3D.vector_access`` says so, else single cells), the lanes of a row
taking its parts, every live cell as it is and every other cell 0 (one
run a row: ``lim = n - gz - gy`` inside the cube, 0 outside).  Then a lane
takes ``xw`` cells of a tile row and walks z over a segment of ``zs``
planes with the plane sums before, at and after its cell in registers;
each row read takes the lane's own cells in one load and the cells beside
them from the neighbouring lanes (shuffles), or from shared memory for a
row's first and last lane.  The count is ``((P[z-1] + P[z]) + P[z+1]) -
centre`` with ``P = (R[y-1] + R[y]) + R[y+1]`` and ``R = (h[x-1] + h[x]) +
h[x+1]``, in an unsigned integer for integer states and float32 for
floating ones; results go out as one store of ``xw`` cells where all lie
on the domain, else cell by cell.

Here, with numpy and no JAX call: the layout rule's invariants, and an
emulation of that walk (the lane bookkeeping of staging and count, the
shuffles as lane rolls, the masks, the order of adds, the stores and their
alignment) bit-equal to ``CA3D.plain_`` for hmap, octant, table, bb and
composite, at rho 2, 3, 4 and 8, in every CA dtype on 0/1 states with live
cells above the tetrahedron, and on int8 and int32 states of any value,
where the sums wrap.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro_torch.kernels import legacy as TL
from repro_torch.kernels import policy

WARP = 32
NP = {torch.int8: np.int8, torch.uint8: np.uint8, torch.int16: np.int16,
      torch.int32: np.int32, torch.int64: np.int64, torch.bfloat16: ml_dtypes.bfloat16,
      torch.float16: np.float16, torch.float32: np.float32}
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _name(t):
    return str(t).split(".")[-1]


def _aligned(count: int, dtype, lead_bytes: int = 0) -> np.ndarray:
    """A flat array of ``count`` elements starting ``lead_bytes`` past a
    16-byte boundary."""
    size = np.dtype(NP[dtype]).itemsize
    store = np.zeros(count * size + 64, np.uint8)
    start = -store.ctypes.data % 16 + lead_bytes
    return store[start:start + count * size].view(NP[dtype])


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == np.dtype(ml_dtypes.bfloat16):
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _blocks(sched, warps: int) -> tuple:
    """``(valid, org)``: per block and warp, the step's valid flag and its
    array-axis tile origin (z0, y0, x0), as lane 0 of each warp puts them in
    the block's table (block ``b``'s warp ``w`` is step ``b * warps + w``;
    a warp past the schedule's end has no valid step)."""
    blocks = -(-sched.steps // warps)
    lin = np.arange(blocks * warps)
    live = lin < sched.steps
    lin = np.where(live, lin, 0)
    tab = sched.prefetch
    out = sched.map(lin) if tab is None else sched.map(lin, tab)
    valid = np.broadcast_to(np.asarray(out[-1], bool), lin.shape) & live
    org = np.stack([np.asarray(c, np.int64) for c in out[-2::-1]], 1)
    return valid.reshape(blocks, warps), org.reshape(blocks, warps, 3)


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

    def widen(self, v: np.ndarray) -> np.ndarray:
        if self.float:
            return v.astype(np.float32)
        return v.view(self.u).astype(self.a)

    def is_(self, a: np.ndarray, v: int) -> np.ndarray:
        if self.float:
            return a == np.float32(v)
        return a.astype(self.u) == np.array(v).astype(self.t).view(self.u)


def stage(inp: np.ndarray, org: np.ndarray, rho: int, tiles: int, rs: int, pe: int,
          nt: int, length: int) -> np.ndarray:
    """``(S, length)`` halos of ``tiles`` tiles side by side from the tile
    origins ``org`` as ``nt`` threads stage them, over poisoned memory (a
    cell the walk reads but staging never wrote would show)."""
    n, size = inp.shape[0], inp.itemsize
    H, parts = rho + 2, tiles * rho // pe + 2
    taken = np.zeros(H * H * parts, int)  # each (row, part) by exactly one thread
    for t in range(nt):
        taken[t::nt] += 1
    assert (taken == 1).all()
    assert (H * H - 1) * rs + parts * pe <= length
    flat = inp.reshape(-1)
    halo = np.full((len(org), length), np.array(5).astype(inp.dtype), inp.dtype)
    for hr in range(H * H):
        hz, hy = divmod(hr, H)
        gz, gy = org[:, 0] + hz - 1, org[:, 1] + hy - 1
        inside = (gz >= 0) & (gz < n) & (gy >= 0) & (gy < n)
        lim = np.where(inside, n - gz - gy, 0)
        base = (np.clip(gz, 0, n - 1) * n + np.clip(gy, 0, n - 1)) * n
        for p in range(parts):
            xs = org[:, 2] + (p - 1) * pe
            cnt = np.clip(np.where(xs < 0, 0, lim - xs), 0, pe)
            if pe > 1:  # a 16-byte piece: both ends on 16-byte boundaries
                assert ((hr * rs + p * pe) * size) % 16 == 0
                assert (((base + xs) * size)[cnt > 0] % 16 == 0).all()
            for i in range(pe):
                live = i < cnt
                src = np.where(live, base + xs + i, 0)
                halo[:, hr * rs + p * pe + i] = np.where(live, flat[src], np.zeros((), inp.dtype))
    return halo


def count(inp: np.ndarray, out: np.ndarray, halo: np.ndarray, at: np.ndarray, org: np.ndarray,
          rho: int, lay: dict, rs: int, written: list) -> None:
    """One warp's count and rule for each of ``len(org)`` tiles, its cells
    at element ``at`` of its row of ``halo`` (past the lead piece), rows
    ``rs`` apart; the results into ``out``."""
    n, size = inp.shape[0], inp.itemsize
    pe, xw, zs = lay["pe"], lay["xw"], lay["zs"]
    cnt = _Count(inp.dtype)
    H, ps = rho + 2, (rho + 2) * rs
    vr = rho // xw
    lr, chunks = min(vr, WARP), -(-vr // WARP)
    groups = WARP // lr
    lane = np.arange(WARP)
    gi, li = lane // lr, lane % lr
    items = rho * (rho // zs) * chunks
    one, zero = np.array(1).astype(inp.dtype), np.array(0).astype(inp.dtype)
    flat_out = out.reshape(-1)
    tiles = np.arange(len(org))[:, None, None]
    for base in range(0, items, groups):
        r = base + gi
        act = (gi < groups) & (r < items)
        r = np.where(act, r, 0)
        c, r = r % chunks, r // chunks
        y, seg = r % rho, r // rho
        xp = c * lr + li
        act &= xp < vr
        xp = np.where(act, xp, 0)
        lsm, rsm = li == 0, (li == lr - 1) | (xp == vr - 1)
        zb = seg * zs
        col = at[:, None] + ((zb * H + y) * rs + pe + xp * xw)[None]  # (S, 32)

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

        def plane(pos):
            r0, _ = row(pos)
            r1, cells = row(pos + rs)
            r2, _ = row(pos + 2 * rs)
            return (r0 + r1) + r2, cells

        below, _ = plane(col)
        at_, cen = plane(col + ps)
        gx = org[:, 2, None] + xp * xw
        for dz in range(zs):
            above, nxt = plane(col + (dz + 2) * ps)
            gz = org[:, 0, None] + zb + dz
            gy = org[:, 1, None] + y
            run = n - gz - gy - gx  # (S, 32)
            neigh = ((below + at_) + above) - cnt.widen(cen)
            three = cnt.is_(neigh, 3)
            alive = ((cen == zero) & three) | ((cen == one) & (cnt.is_(neigh, 2) | three))
            res = np.where(alive, one, zero)
            off = (gz * n + gy) * n + gx
            store = act[None] & (run > 0)
            if xw > 1:  # a whole store of xw cells is aligned to its size
                assert ((off * size)[store & (run >= xw)] % (xw * size) == 0).all()
            for i in range(xw):
                keep = store & (i < run)
                flat_out[off[keep] + i] = res[:, :, i][keep]
                written.append(off[keep] + i)
            below, at_, cen = at_, above, nxt


def ca3d_walk(inp: np.ndarray, out: np.ndarray, sched, rho: int, vec: bool) -> dict:
    """``legacy_md.cu``'s CA over one launch: ``out`` (a copy of ``inp``)
    gets the stepped domain cells of every visited tile.  Returns how many
    blocks shared one halo and how many staged a slice a warp."""
    n, size = inp.shape[0], inp.itemsize
    lay = TL.CA3D.layout(rho, size, vec)
    pe, warps, rs, rs1 = lay["pe"], lay["warps"], lay["rs"], lay["rs1"]
    assert lay["smem"] and rho % lay["zs"] == 0 and rho % lay["xw"] == 0
    assert lay["slots"] >= 1 and lay["slots"] * lay["slice"] * size <= lay["smem"] - TL.CA3D.TABLE
    valid, blk = _blocks(sched, warps)
    org = blk * rho  # (B, warps, 3) tile origins (z, y, x)
    k = np.arange(warps)
    side = (valid.all(1) & (org[:, :, :2] == org[:, :1, :2]).all((1, 2))
            & (org[:, :, 2] == org[:, :1, 2] + k * rho).all(1))  # the tiles a row along x
    written = []
    if side.any():  # one halo for the block's warps, staged by all its threads
        length = (lay["smem"] - TL.CA3D.TABLE) // size
        halo = stage(inp, org[side, 0], rho, warps, rs, pe, 32 * warps, length)
        halo = np.repeat(halo, warps, 0)  # each warp reads the block's halo
        at = np.tile(k * rho, int(side.sum()))  # at its tile's cells
        count(inp, out, halo, at, org[side].reshape(-1, 3), rho, lay, rs, written)
    alone = valid & ~side[:, None]
    if alone.any():  # a slice a warp, `slots` warps at a time
        slot = np.broadcast_to(k % lay["slots"], valid.shape)[alone]
        halo = stage(inp, org[alone], rho, 1, rs1, pe, WARP, lay["slice"])
        count(inp, out, halo, np.zeros(len(halo), np.int64), org[alone], rho, lay, rs1, written)
        assert (slot < lay["slots"]).all()
    written = np.concatenate(written)
    assert len(np.unique(written)) == len(written)  # no cell written twice
    z, yy, x = np.indices((rho,) * 3).reshape(3, -1)
    g = org[valid][:, None, :] + np.stack([z, yy, x], 1)[None]
    want = np.ravel_multi_index(tuple(np.moveaxis(g, -1, 0)), inp.shape)[g.sum(-1) < n]
    assert np.array_equal(np.sort(written), np.sort(want))  # every domain cell of every tile
    return dict(shared=int(side.sum()), alone=int(alone.sum()))


def _state(n: int, dtype, seed: int, anyval: bool = False) -> np.ndarray:
    """A state over the whole cube (live cells above the tetrahedron too):
    0/1 of density 0.35, or any value of the type's range."""
    rng = np.random.default_rng(seed)
    if anyval:
        info = np.iinfo(NP[dtype])
        v = rng.integers(info.min, info.max, (n,) * 3, endpoint=True, dtype=np.int64)
        # half the cells 0/1, so that some counts wrap to 2 or 3
        v = np.where(rng.random(v.shape) < 0.5, rng.integers(0, 2, v.shape), v)
        return v.astype(NP[dtype])
    return (rng.random((n,) * 3) < 0.35).astype(NP[dtype])


def _check(n, rho, kind, dtype, seed, anyval=False, lead_bytes=0):
    """The walk on a fresh state, bit-equal to the plain version; returns
    the access path and the blocks' modes."""
    flat = _aligned(n**3, dtype, lead_bytes)
    inp = flat.reshape((n,) * 3)
    inp[...] = _state(n, dtype, seed, anyval)
    out = _aligned(n**3, dtype, lead_bytes).reshape((n,) * 3)
    out[...] = inp
    size = inp.itemsize
    vec = TL.CA3D.vector_access(rho, size, out.ctypes.data, inp.ctypes.data)
    t_in = _torch(inp)
    assert vec is TL.CA3D.vector_access(rho, t_in.element_size(), out.ctypes.data,
                                        t_in.data_ptr())
    sched = TL._schedule(3, n // rho, kind)
    modes = ca3d_walk(inp, out, sched, rho, vec)
    want = inp.copy()
    TL.CA3D.plain_(_torch(want), t_in, sched, rho)
    assert np.array_equal(out.view(np.uint8), want.view(np.uint8))
    assert not np.array_equal(out.view(np.uint8), inp.view(np.uint8))
    return vec, modes


# ---------------------------------------------------------------- the rule


@pytest.mark.parametrize("dtype", policy.CA_DTYPES, ids=_name)
def test_layout_rule(dtype):
    size = torch.empty((), dtype=dtype).element_size()
    for rho in (1, 2, 3, 4, 8, 12, 16, 32):
        for vec in (False, True):
            if vec and (rho * size) % 16:
                continue
            lay = TL.CA3D.layout(rho, size, vec)
            pe, xw, rs, rs1, w = lay["pe"], lay["xw"], lay["rs"], lay["rs1"], lay["warps"]
            assert pe == (16 // size if vec else 1) and rho % xw == 0 and pe % xw == 0
            assert rs1 >= rho + 2 * pe and rs >= w * rho + 2 * pe and rs % pe == rs1 % pe == 0
            assert rho % lay["zs"] == 0 and 1 <= w <= TL.CA3D.WARPS
            assert lay["slice"] * size % 16 == 0 and lay["slice"] >= rs1 * (rho + 2) ** 2
            assert (lay["smem"] > 0) is (TL.CA3D.smem_bytes(rho, size, vec) <= policy.SMEM_LIMIT)
            if lay["smem"]:
                halo = lay["smem"] - TL.CA3D.TABLE
                assert halo >= rs * (rho + 2) ** 2 * size
                assert halo >= lay["slots"] * lay["slice"] * size and lay["slots"] >= 1
                assert w == 1 or halo <= TL.CA3D.BUDGET
        # the least block (single cells) is what the entry point checks
        assert TL.CA3D.smem_bytes(rho, size) == TL.CA3D.TABLE + TL.CA3D.layout(
            rho, size, False)["slice"] * size
    # the main case: 8 warps sharing rows of 64 cells and two pieces,
    # slices of 6 pieces a row when they cannot share
    lay = TL.CA3D.layout(8, 4, True)
    assert (lay["warps"], lay["rs"], lay["rs1"], lay["zs"], lay["smem"]) == (8, 72, 24, 4, 28928)


def test_vector_access_needs_both_buffers_aligned():
    assert TL.CA3D.vector_access(8, 4, 0, 16)
    assert not TL.CA3D.vector_access(8, 4, 4, 16)
    assert not TL.CA3D.vector_access(8, 4, 16, 4)
    assert not TL.CA3D.vector_access(2, 4, 0, 0)  # 8 bytes a row: single cells
    assert TL.CA3D.vector_access(2, 8, 0, 0)
    assert not TL.CA3D.vector_access(36, 4, 0, 0)  # the padded slice would not fit


# ---------------------------------------------------------------- the walk


# (n, rho, kind): rho 4 and 8 on 16-byte pieces in int32, rho 2 and 3 on
# single cells; composite at a non-power-of-two tile count.  From 16 tiles
# a side the recursion's cubes reach 8 tiles, so blocks whose eight steps
# are a row of tiles along x share one halo (at 32 tiles a side most valid
# steps do; at the main case's 128, 92 %); the rest stage a slice a warp.
KIND_CASES = [(128, 4, "hmap"), (64, 4, "octant"), (64, 4, "table"), (128, 8, "hmap"),
              (32, 4, "bb"), (48, 4, "composite"), (32, 2, "hmap"), (24, 3, "composite"),
              (18, 3, "bb")]


@pytest.mark.parametrize("case", KIND_CASES, ids=lambda c: "-".join(map(str, c)))
def test_walk_every_kind_is_bit_equal_to_plain(case):
    n, rho, kind = case
    vec, modes = _check(n, rho, kind, torch.int32, seed=n * 10 + rho)
    assert vec is ((rho * 4) % 16 == 0)
    assert modes["alone"] > 0  # blocks with invalid steps or a turn in the walk
    if n // rho >= 16:
        assert modes["shared"] > 0
    if n // rho >= 32:
        assert TL.CA3D.WARPS * modes["shared"] > modes["alone"]


@pytest.mark.parametrize("dtype", policy.CA_DTYPES, ids=_name)
def test_walk_every_dtype_on_01_states(dtype):
    # rho 8: pieces for the 2-, 4- and 8-byte types, single cells for the
    # 1-byte ones; rho 16 at n 32: pieces for every type (8 warps of int8
    # rows of one piece, int64 two cells a lane)
    size = torch.empty((), dtype=dtype).element_size()
    assert _check(16, 8, "hmap", dtype, seed=3)[0] is ((8 * size) % 16 == 0)
    assert _check(32, 16, "bb", dtype, seed=4)[0]


@pytest.mark.parametrize("dtype", (torch.int8, torch.int32), ids=_name)
@pytest.mark.parametrize("rho", (2, 4, 8))
def test_walk_states_of_any_value_wrap(dtype, rho):
    _check(16, rho, "hmap", dtype, seed=rho, anyval=True)


def test_walk_on_misaligned_buffers_takes_single_cells():
    # one element past a 16-byte boundary: the rule says no, the walk
    # stages and stores single cells
    assert not _check(16, 8, "table", torch.int32, seed=9, lead_bytes=4)[0]


def test_most_steps_share_a_halo_at_the_main_size():
    # m=3 n=1024 rho=8 (nb 128), the card's main case: the recursion walks
    # x fastest inside cubes of 8 tiles and more, so 92 % of hmap's valid
    # steps fall in blocks whose 8 tiles lie side by side along x
    sched = TL._schedule(3, 128, "hmap")
    valid, blk = _blocks(sched, TL.CA3D.WARPS)
    k = np.arange(TL.CA3D.WARPS)
    side = (valid.all(1) & (blk[:, :, :2] == blk[:, :1, :2]).all((1, 2))
            & (blk[:, :, 2] == blk[:, :1, 2] + k).all(1))
    share = side.sum() * TL.CA3D.WARPS / valid.sum()
    assert valid.sum() == 357760 and 0.91 < share < 0.93
