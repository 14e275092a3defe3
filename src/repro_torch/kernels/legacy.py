"""Frozen originals — the differential baseline of the engine.

These are the port of the JAX package's ``kernels/legacy.py``: the
original per-(body, dimension) kernels that predate the
dimension-generic ``SimplexKernel`` engine (``kernels/engine.py``,
DESIGN.md §2.3).  The 2-D ones (``map2d``, ``accum2d``, ``edm2d``,
``ca2d``) launch the paper's two-dimensional ``(w, h)`` grid: block
``(wx, wy)`` goes through the schedule's map H: Z^2 -> Z^2 to its
``(column, row)`` tile, and the tile's rule runs there.  The m >= 3 ones
(``accum3d``, ``ca3d``, ``accum_md``) launch a linear grid: step ``i``
goes through ``SimplexSchedule(m, nb, kind).map`` to its math-order
block ``(x_0, ..., x_{m-1})``, and array axis j holds ``x_{m-1-j}``.

They stay independent of the engine on purpose: ``chip_smoke.py`` and
the tests hold the engine against them, so if they shared its code the
comparison would hold the engine against itself.  They share only the
schedule subsystem (``core/schedule.py``, and ``SimplexMap`` with its map
functions in ``csrc/simplex_maps.cuh``) and the device policy.  Do not
add kernels here and do not make these share code with the engine.

Each kernel has two versions of its work on one schedule:

* ``kernel*`` — the CUDA kernel of ``csrc/legacy2d.cu`` or
  ``csrc/legacy_md.cu`` for CUDA tensors; it checks its operands,
  launches on the current stream and adds one to its ``launches``
  counter;
* ``plain*`` — a plain PyTorch version that walks every grid step
  through the torch backend of the schedule's map and applies the tile's
  rule with tensor ops on tile views.  CPU tensors take it; on the card
  it is the kernel's reference and nothing else.

The write discipline is the reference's: ACCUM and CA keep their input
off the domain, EDM keeps its zeros seed.  The TPU kernels flushed every
grid step back through input/output aliasing, parking invalid steps on a
trash tile; here an invalid step writes nothing, and CA writes a second
buffer because blocks run in no order.  ``kind='auto'`` (the default of
every entry point but ``map2d``) resolves through the autotuner for the
device the operand lives on; ``split=None`` asks it whether to launch a
composite walk one piece at a time.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..autotune.tuner import should_split_pieces
from ..core.schedule import SimplexSchedule, resolve_kind
from . import _build
from .policy import (ACCUM_DTYPES, CA_DTYPES, DTYPE_CODES, EDM_DTYPES, SMEM_LIMIT,
                     card_operand, check_tile, on_card, resolve_device)

__all__ = [
    "map2d",
    "accum2d",
    "edm2d",
    "ca2d",
    "accum3d",
    "ca3d",
    "accum_md",
    "grid_steps_2d",
    "grid_steps_3d",
    "MAP2D",
    "ACCUM2D",
    "EDM2D",
    "CA2D",
    "ACCUM3D",
    "CA3D",
    "ACCUM_MD",
    "launch_counts",
    "legacy_vector_access",
]

# Elements per chunk of a plain version's tile gather (bounds its memory).
_CHUNK_ELEMS = 1 << 22
_KIND_CODES = {"hmap": 0, "rb": 1, "bb": 2}


# ---------------------------------------------------------------------------
# schedule plumbing
# ---------------------------------------------------------------------------


def _schedule(m: int, nb: int, kind: str, device=None) -> SimplexSchedule:
    """Resolve the schedule (``'auto'`` for ``device``, None the card),
    enforcing the legacy 2D kind restriction."""
    if m == 2 and kind in ("table", "composite"):
        raise ValueError(
            f"the 2D kernels launch a (w, h) grid; kind={kind!r} (linear "
            "walk) is only wired for the m >= 3 kernels — use kind='hmap', "
            "'rb', or 'bb'"
        )
    return SimplexSchedule(m, nb, resolve_kind(m, nb, kind, device))


def grid_steps_2d(nb: int, kind: str) -> int:
    """Grid steps of the legacy 2D (w, h)-grid schedule.

    Example:
        >>> grid_steps_2d(16, "hmap"), grid_steps_2d(6, "hmap"), grid_steps_2d(5, "hmap")
        (136, 21, 25)
    """
    return _schedule(2, nb, kind).steps


def grid_steps_3d(nb: int, kind: str) -> int:
    """Grid steps of the legacy 3D linear-grid schedule (host only).

    Example:
        >>> grid_steps_3d(8, "octant"), grid_steps_3d(8, "bb")
        (160, 512)
    """
    return _schedule(3, nb, kind).steps


def _grid_points(sched, lin: torch.Tensor):
    """``(x, y, valid)`` of linear grid steps ``lin`` (grid axis 0
    fastest) through the torch backend of the schedule's map."""
    w = sched.grid[0]
    wy = lin // w
    return sched.map(lin - wy * w, wy)


def _tiles(sched, device, per: int):
    """Per chunk of the grid: int64 ``(col, row)`` blocks of its valid
    steps, ``per`` elements of work per step."""
    step = max(1, _CHUNK_ELEMS // per)
    lin = torch.arange(sched.steps, dtype=torch.int64, device=device)
    for s0 in range(0, sched.steps, step):
        x, y, v = _grid_points(sched, lin[s0:s0 + step])
        v = torch.as_tensor(v, device=device).to(torch.bool)
        yield x[v].to(torch.int64), y[v].to(torch.int64)


def _tile_view(a: torch.Tensor, rho: int) -> torch.Tensor:
    """``(nb, nb, rho, rho)`` view of an ``(n, n)`` array: [row block,
    column block] -> tile, writable through index assignment."""
    nb = a.shape[0] // rho
    return a.view(nb, rho, nb, rho).permute(0, 2, 1, 3)


def _tri(xb: torch.Tensor, yb: torch.Tensor, rho: int) -> torch.Tensor:
    """``(S, rho, rho)`` mask of ``col <= row`` over the tiles."""
    r = torch.arange(rho, device=xb.device)
    rows = yb[:, None, None] * rho + r[None, :, None]
    cols = xb[:, None, None] * rho + r[None, None, :]
    return cols <= rows


def _check_square(name: str, a: torch.Tensor, rho: int, smem_bytes: int = 0) -> int:
    n = a.shape[0] if a.ndim else 0
    if a.ndim != 2 or tuple(a.shape) != (n, n):
        raise ValueError(f"{name}: expected a square (n, n) operand, got {tuple(a.shape)}")
    check_tile(name, 2, n, rho, smem_bytes)
    return n


def _kind_code(name: str, sched) -> int:
    """The device map code of a (w, h)-grid schedule."""
    if sched.m != 2 or sched.kind not in _KIND_CODES:
        raise ValueError(f"{name}: the (w, h) grid serves m=2 hmap/rb/bb, got "
                         f"m={sched.m} kind={sched.kind!r}")
    return _KIND_CODES[sched.kind]


def _check_launch(name: str, sched, rho: int, a: torch.Tensor, dtypes,
                  smem_bytes: int = 0) -> int:
    """The kernel's contract, checked before any build or launch.

    Returns:
        The schedule's device map code.
    """
    n = _check_square(name, a, rho, smem_bytes)
    if n != sched.n * rho:
        raise ValueError(
            f"{name}: schedule (nb={sched.n}) at rho={rho} needs a "
            f"({sched.n * rho}, {sched.n * rho}) operand, got {tuple(a.shape)}"
        )
    code = _kind_code(name, sched)
    card_operand(a, name, dtypes)
    return code


class _Legacy:
    """A legacy kernel's launch counter and its launch through ``_build``.

    Attributes:
        launches: Launches of the CUDA kernel so far, never of the plain
            version.
    """

    name = ""

    def __init__(self):
        self.launches = 0

    def _launch(self, entry: str, device: torch.device, *args) -> None:
        lib = _build.library()
        with torch.cuda.device(device):
            code = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
        _build.check(code, self.name)
        self.launches += 1


# ---------------------------------------------------------------------------
# MAP — mapping stage only (the paper's theoretical-speedup microbenchmark)
# ---------------------------------------------------------------------------


class Map2DKernel(_Legacy):
    """MAP: ``(steps, 3)`` int32 ``(x, y, valid)`` per grid step.

    ``lin`` is padded to whole chunks and clamped to ``steps - 1``, as in
    the reference; the padded rows are cut off.
    """

    name = "map2d"

    @staticmethod
    def _rows(sched, chunk: int) -> int:
        if not 1 <= chunk <= 1024:
            raise ValueError(f"map2d: chunk={chunk} threads must lie in 1..1024")
        return -(-sched.steps // chunk) * chunk

    def plain(self, sched, chunk: int, device) -> torch.Tensor:
        """The table through the torch backend of the map."""
        rows = self._rows(sched, chunk)
        lin = torch.arange(rows, dtype=torch.int64, device=device).clamp_(max=sched.steps - 1)
        x, y, v = _grid_points(sched, lin)
        v = torch.as_tensor(v, device=device)
        return torch.stack([x.to(torch.int32), y.to(torch.int32), v.to(torch.int32)],
                           dim=1)[:sched.steps]

    def kernel(self, sched, chunk: int, device) -> torch.Tensor:
        """The table from ``legacy2d.cu``: one thread per step, ``chunk``
        threads per block."""
        rows = self._rows(sched, chunk)
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"map2d kernel runs on a CUDA device, got {device}")
        code = _kind_code(self.name, sched)
        out = torch.empty((rows, 3), dtype=torch.int32, device=device)
        self._launch("legacy_map2d_launch", device, out.data_ptr(), code, sched.n, chunk,
                     rows)
        return out[:sched.steps]


MAP2D = Map2DKernel()


def map2d(nb: int, kind: str = "hmap", chunk: int = 128, device=None) -> torch.Tensor:
    """The MAP test over the 2-simplex's (w, h) grid.

    Args:
        nb: Tile count per side.
        kind: ``'hmap'``, ``'rb'`` or ``'bb'`` (resolved at non-power-of-two
            ``nb`` as the engine resolves it).
        chunk: Steps per block (threads of a CUDA block).
        device: None for the card, ``'cpu'`` for the plain version.

    Returns:
        ``(steps, 3)`` int32: ``(x, y, valid)`` per grid step.

    Example:
        >>> map2d(2, device="cpu").tolist()
        [[0, 0, 1], [0, 1, 1], [1, 1, 1]]
    """
    device = resolve_device(device)
    sched = _schedule(2, nb, kind, device)
    if device.type == "cuda":
        return MAP2D.kernel(sched, chunk, device)
    if device.type != "cpu":
        raise ValueError(f"map2d: no kernel for {device}")
    return MAP2D.plain(sched, chunk, device)


# ---------------------------------------------------------------------------
# ACCUM — +1 on each simplex element (memory-bound test)
# ---------------------------------------------------------------------------


class Accum2DKernel(_Legacy):
    """ACCUM: +1 where ``col <= row`` on the tiles the grid visits."""

    name = "accum2d"

    def plain_(self, buf: torch.Tensor, sched, rho: int) -> None:
        """+1 on the triangle of each visited tile of ``buf``, in place."""
        tiles = _tile_view(buf, rho)
        for xb, yb in _tiles(sched, buf.device, rho * rho):
            t = tiles[yb, xb]
            tiles[yb, xb] = torch.where(_tri(xb, yb, rho), t + 1, t)

    def kernel_(self, buf: torch.Tensor, sched, rho: int) -> None:
        """+1 on the triangle of each visited tile of ``buf``, in place
        (``legacy2d.cu``: a warp per grid point, 8 a block; 16-byte pieces
        where ``legacy_vector_access`` says so, single elements
        elsewhere)."""
        code = _check_launch(self.name, sched, rho, buf, ACCUM_DTYPES)
        vec = legacy_vector_access(rho, buf.element_size(), buf.data_ptr())
        self._launch("legacy_accum2d_launch", buf.device, buf.data_ptr(),
                     DTYPE_CODES[buf.dtype], code, sched.n, buf.shape[0], rho, int(vec))


ACCUM2D = Accum2DKernel()


def accum2d(x, rho: int = 8, kind: str = "auto", device=None) -> torch.Tensor:
    """+1 on the inclusive lower triangle of ``x`` (n x n, rho | n).

    Args:
        x: ``(n, n)`` array or tensor (on the card any of
            ``policy.ACCUM_DTYPES``; +1 in its own type).
        rho: Tile side.
        kind: ``'hmap'``, ``'rb'``, ``'bb'`` or ``'auto'``.
        device: None for the card, ``'cpu'`` for the plain version.

    Returns:
        A new tensor: ``x`` with +1 where ``col <= row``, its input
        elsewhere; ``x`` itself is not changed.

    Example:
        >>> accum2d(torch.zeros(4, 4, dtype=torch.int32), rho=2, device="cpu").sum().item()
        10
    """
    buf = torch.as_tensor(x, device=resolve_device(device)).contiguous().clone()
    n = _check_square(ACCUM2D.name, buf, rho)
    sched = _schedule(2, n // rho, kind, buf.device)
    if on_card(buf, ACCUM2D.name):
        ACCUM2D.kernel_(buf, sched, rho)
    else:
        ACCUM2D.plain_(buf, sched, rho)
    return buf


# ---------------------------------------------------------------------------
# EDM — Euclidean distance matrix (arithmetic-heavy test)
# ---------------------------------------------------------------------------


class EDM2DKernel(_Legacy):
    """EDM: ``||p_r - p_c||`` where ``col <= row``, direct-difference form
    in float32; the zeros seed elsewhere."""

    name = "edm2d"
    # legacy2d.cu: a thread's rows and columns of a tile, a block's threads
    # at most and grid points at most, the ints of a pass's table
    ROWS, COLS, THREADS, MAX_TILES, TABLE = 4, 4, 128, 16, 96

    @classmethod
    def _slot(cls, rho: int, d: int) -> tuple:
        """``(tr, tc, ld, pts)``: threads down and across a tile, floats a
        staged point (``ld / 4`` odd), points a slot; point ``q`` sits at
        ``q * ld + 4 * (q // 4)`` floats of its slot."""
        tr, tc, k4 = -(-rho // cls.ROWS), -(-rho // cls.COLS), -(-d // 4)
        ld = 4 * (k4 if k4 % 2 else k4 + 1)
        return tr, tc, ld, max(cls.ROWS * tr, cls.COLS * tc)

    @classmethod
    def layout(cls, rho: int, d: int, w: int) -> dict:
        """``legacy2d.cu``'s block at tile side ``rho``, ``d`` coordinates
        and grid width ``w`` (``legacy_edm2d_layout``).

        Returns:
            ``tr`` and ``tc`` threads down and across a tile (a thread's
            ``ROWS x COLS`` cells), ``ld`` floats a staged point, ``pts``
            points a slot, ``tiles`` grid points a block, ``slots`` point
            blocks staged at once, ``threads`` and ``smem`` (bytes; 0
            where one grid point does not fit).

        Example:
            >>> L = EDM2DKernel.layout(16, 64, 512)
            >>> [L[k] for k in ("tr", "tc", "ld", "tiles", "slots", "threads", "smem")]
            [4, 4, 68, 8, 10, 128, 44544]
        """
        tr, tc, ld, pts = cls._slot(rho, d)
        g = min(max(cls.THREADS // (tr * tc), 1), cls.MAX_TILES, w)
        while True:
            slots = 2 if g == 1 else g + 2
            smem = 4 * (pts * ld + pts) * slots + 4 * cls.TABLE
            if smem <= SMEM_LIMIT or g == 1:
                break
            g -= 1
        threads = -(-min(g * tr * tc, cls.THREADS) // 32) * 32
        return dict(tr=tr, tc=tc, ld=ld, pts=pts, tiles=g, slots=slots, threads=threads,
                    smem=smem if smem <= SMEM_LIMIT else 0)

    @classmethod
    def smem_bytes(cls, rho: int, d: int) -> int:
        """The least shared memory a block needs: one grid point's row and
        column point blocks as ``layout`` stages them, and the table."""
        _, _, ld, pts = cls._slot(rho, d)
        return 2 * 4 * (pts * ld + pts) + 4 * cls.TABLE

    def plain_(self, out: torch.Tensor, p: torch.Tensor, sched, rho: int) -> None:
        """Write the triangle of each visited tile of ``out``."""
        pf = p.to(torch.float32)
        tiles = _tile_view(out, rho)
        r = torch.arange(rho, device=p.device)
        for xb, yb in _tiles(sched, out.device, rho * rho * p.shape[1]):
            pr = pf[yb[:, None] * rho + r]  # (S, rho, d) row points
            pc = pf[xb[:, None] * rho + r]  # (S, rho, d) column points
            d2 = ((pr[:, :, None, :] - pc[:, None, :, :]) ** 2).sum(-1)
            dist = torch.sqrt(d2)
            tiles[yb, xb] = torch.where(_tri(xb, yb, rho), dist, 0.0).to(out.dtype)

    def kernel_(self, out: torch.Tensor, p: torch.Tensor, sched, rho: int) -> None:
        """Write the triangle of each visited tile of ``out`` (``legacy2d.cu``:
        points staged in 16-byte pieces where ``legacy_vector_access(d, 4,
        ptr)`` says so, single floats elsewhere)."""
        if p.ndim != 2 or p.shape[0] != out.shape[0]:
            raise ValueError(f"{self.name}: expected ({out.shape[0]}, d) points, got "
                             f"{tuple(p.shape)}")
        code = _check_launch(self.name, sched, rho, out, EDM_DTYPES,
                             self.smem_bytes(rho, p.shape[1]))
        card_operand(p, self.name, EDM_DTYPES)
        if p.device != out.device:
            raise ValueError(f"{self.name}: points on {p.device}, output on {out.device}")
        pf = p.to(torch.float32).contiguous()
        vec = legacy_vector_access(p.shape[1], 4, pf.data_ptr())
        self._launch("legacy_edm2d_launch", out.device, out.data_ptr(),
                     DTYPE_CODES[out.dtype], pf.data_ptr(), p.shape[1], code, sched.n,
                     out.shape[0], rho, int(vec))


EDM2D = EDM2DKernel()


def edm2d(p, rho: int = 8, kind: str = "auto", device=None) -> torch.Tensor:
    """``out[i, j] = ||p_i - p_j||`` on the inclusive lower triangle.

    Args:
        p: ``(n, d)`` points (float16, bfloat16, float32 or float64 on
            the card); the distances are computed in float32.
        rho: Tile side.
        kind: ``'hmap'``, ``'rb'``, ``'bb'`` or ``'auto'``.
        device: None for the card, ``'cpu'`` for the plain version.

    Returns:
        ``(n, n)`` tensor in ``p.dtype``; 0 above the diagonal.

    Example:
        >>> p = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
        >>> edm2d(p, rho=1, device="cpu").tolist()
        [[0.0, 0.0], [5.0, 0.0]]
    """
    p = torch.as_tensor(p, device=resolve_device(device)).contiguous()
    if p.ndim != 2:
        raise ValueError(f"edm2d: expected (n, d) points, got {tuple(p.shape)}")
    n, d = p.shape
    check_tile(EDM2D.name, 2, n, rho, EDM2D.smem_bytes(rho, d))
    sched = _schedule(2, n // rho, kind, p.device)
    out = torch.zeros((n, n), dtype=p.dtype, device=p.device)
    if on_card(out, EDM2D.name):
        EDM2D.kernel_(out, p, sched, rho)
    else:
        EDM2D.plain_(out, p, sched, rho)
    return out


# ---------------------------------------------------------------------------
# CA2D — game of life on the triangle, periodic wrap (memory-bound, halos)
# ---------------------------------------------------------------------------


def _halo_row(rho: int, tiles: int, pe: int, vec: bool) -> int:
    """A CA original's halo row stride (``legacy2d.cu``, ``legacy_md.cu``):
    a lead piece, ``tiles * rho`` cells, a trail piece; two pieces more
    where that is a multiple of four pieces (so that rows read at once fall
    on distinct banks)."""
    rs = tiles * rho + 2 * pe
    return rs + 2 * pe if vec and (rs // pe) % 4 == 0 else rs


class CA2DKernel(_Legacy):
    """CA: one B3/S23 step on the triangle of a periodic square.

    Each tile reads its ``(rho+2)^2`` halo, every cell masked by
    ``col <= row`` at its own wrapped position; cells off the triangle
    keep their input.
    """

    name = "ca2d"
    # legacy2d.cu: grid points (warps) a block at most, a shared halo's
    # bytes at most
    WARPS, BUDGET = 8, 56 * 1024

    @classmethod
    def layout(cls, rho: int, itemsize: int, vec: bool) -> dict:
        """``legacy2d.cu``'s block (``legacy_ca2d_layout``).

        Returns:
            ``pe`` cells a staging piece (16 bytes on the vector path, else
            1), ``xw`` cells a lane counts at once, ``warps`` a block (8,
            fewer where the side-by-side or stacked halo would pass
            ``BUDGET``), ``rs`` the side-by-side halo's row stride, ``rs1``
            a one-tile-wide halo's (stacked tiles and the slices), ``ys``
            the rows a lane walks, ``slice`` a slice's elements (16-byte
            rounded), ``slots`` the slices the block's memory holds and
            ``smem`` that memory in bytes (0 where one slice does not fit a
            block).

        Example:
            >>> L = CA2DKernel.layout(16, 4, True)
            >>> [L[k] for k in ("pe", "xw", "warps", "rs", "rs1", "ys", "slice", "slots", "smem")]
            [4, 4, 8, 136, 24, 2, 432, 8, 13824]
            >>> CA2DKernel.layout(64, 4, True)["warps"], CA2DKernel.layout(3, 4, False)["ys"]
            (3, 1)
        """
        pe = 16 // itemsize if vec else 1
        xw = (2 if itemsize == 8 else 4) if vec else 1
        rs1 = _halo_row(rho, 1, pe, vec)
        one = -(-(rho + 2) * rs1 * itemsize // 16) * 16
        for warps in range(cls.WARPS, 0, -1):
            rs = _halo_row(rho, warps, pe, vec)
            side = -(-(rho + 2) * rs * itemsize // 16) * 16
            stack = -(-(warps * rho + 2) * rs1 * itemsize // 16) * 16
            halo = max(side, stack)
            if warps == 1 or halo <= cls.BUDGET:
                break
        if halo < warps * one <= cls.BUDGET:
            halo = warps * one
        vr = rho // xw
        lr, chunks = min(vr, 32), -(-vr // 32)
        ys = next((rho // s for s in range(1, rho + 1)
                   if rho % s == 0 and s * chunks >= 32 // lr), 1)
        return dict(pe=pe, xw=xw, warps=warps, rs=rs, rs1=rs1, ys=ys, slice=one // itemsize,
                    slots=min(warps, halo // one), smem=halo if one <= SMEM_LIMIT else 0)

    @classmethod
    def smem_bytes(cls, rho: int, itemsize: int = 4, vec: bool = False) -> int:
        """The least shared memory a block of the kernel needs: one tile's
        ``(rho+2)^2`` halo of ``itemsize``-byte cells as ``layout`` lays it
        out (on single cells, ``itemsize * (rho+2)^2`` rounded to 16 bytes)."""
        rs1 = _halo_row(rho, 1, 16 // itemsize if vec else 1, vec)
        return -(-(rho + 2) * rs1 * itemsize // 16) * 16

    @classmethod
    def vector_access(cls, rho: int, itemsize: int, out_ptr: int, in_ptr: int) -> bool:
        """Whether the kernel stages, reads and stores 16-byte pieces: a
        fixed rule, ``legacy_vector_access`` for both buffers and one
        tile's halo of that layout fitting a block.

        Example:
            >>> CA2DKernel.vector_access(16, 4, 0, 64), CA2DKernel.vector_access(16, 4, 0, 4)
            (True, False)
            >>> CA2DKernel.vector_access(8, 1, 0, 0), CA2DKernel.vector_access(2, 8, 0, 0)
            (False, True)
        """
        return (legacy_vector_access(rho, itemsize, out_ptr)
                and legacy_vector_access(rho, itemsize, in_ptr)
                and cls.smem_bytes(rho, itemsize, True) <= SMEM_LIMIT)

    def plain_(self, out: torch.Tensor, inp: torch.Tensor, sched, rho: int) -> None:
        """Step the triangle of each visited tile from ``inp`` into ``out``."""
        n = inp.shape[0]
        src, dst = _tile_view(inp, rho), _tile_view(out, rho)
        h = torch.arange(-1, rho + 1, device=inp.device)
        for xb, yb in _tiles(sched, inp.device, (rho + 2) ** 2):
            rows = ((yb[:, None] * rho + h) % n)[:, :, None]
            cols = ((xb[:, None] * rho + h) % n)[:, None, :]
            halo = torch.where(cols <= rows, inp[rows, cols], 0)  # (S, rho+2, rho+2)
            centre = halo[:, 1:-1, 1:-1]
            neigh = torch.zeros_like(centre)
            for dy in range(3):
                for dx in range(3):
                    if (dy, dx) != (1, 1):
                        neigh = neigh + halo[:, dy:dy + rho, dx:dx + rho]
            alive = ((centre == 0) & (neigh == 3)) | (
                (centre == 1) & ((neigh == 2) | (neigh == 3)))
            dst[yb, xb] = torch.where(_tri(xb, yb, rho), alive.to(out.dtype), src[yb, xb])

    def kernel_(self, out: torch.Tensor, inp: torch.Tensor, sched, rho: int) -> None:
        """Step the triangle of each visited tile from ``inp`` into ``out``
        (``legacy2d.cu``: 16-byte pieces where ``vector_access`` says so,
        single cells elsewhere); ``out`` must not alias ``inp``."""
        code = _check_launch(self.name, sched, rho, inp, CA_DTYPES,
                             self.smem_bytes(rho, inp.element_size()))
        if out.shape != inp.shape or out.dtype != inp.dtype:
            raise ValueError(f"{self.name}: output {tuple(out.shape)} {out.dtype} and "
                             f"input {tuple(inp.shape)} {inp.dtype} differ")
        card_operand(out, self.name, CA_DTYPES)
        if out.device != inp.device or out.data_ptr() == inp.data_ptr():
            raise ValueError(f"{self.name}: the kernel reads one buffer and writes "
                             "another on the same device")
        vec = self.vector_access(rho, inp.element_size(), out.data_ptr(), inp.data_ptr())
        self._launch("legacy_ca2d_launch", inp.device, out.data_ptr(), inp.data_ptr(),
                     DTYPE_CODES[inp.dtype], code, sched.n, inp.shape[0], rho, int(vec))


CA2D = CA2DKernel()


def ca2d(state, rho: int = 8, kind: str = "auto", device=None) -> torch.Tensor:
    """One Game-of-Life step on the inclusive lower triangle (periodic
    underlying square).

    Args:
        state: ``(n, n)`` 0/1 array (on the card any of
            ``policy.CA_DTYPES``; neighbours counted in its own type).
        rho: Tile side.
        kind: ``'hmap'``, ``'rb'``, ``'bb'`` or ``'auto'``.
        device: None for the card, ``'cpu'`` for the plain version.

    Returns:
        The stepped state; cells above the diagonal keep their input.

    Example:
        >>> s = torch.zeros(4, 4, dtype=torch.int32)
        >>> s[2, 0] = s[2, 1] = s[2, 2] = 1  # a blinker on row 2
        >>> ca2d(s, rho=2, device="cpu")[:, 1].tolist()
        [0, 1, 1, 1]
    """
    inp = torch.as_tensor(state, device=resolve_device(device)).contiguous()
    n = _check_square(CA2D.name, inp, rho, CA2D.smem_bytes(rho, inp.element_size()))
    sched = _schedule(2, n // rho, kind, inp.device)
    out = inp.clone()
    if on_card(inp, CA2D.name):
        CA2D.kernel_(out, inp, sched, rho)
    else:
        CA2D.plain_(out, inp, sched, rho)
    return out


# ---------------------------------------------------------------------------
# the m >= 3 originals: a linear grid of schedule steps
# ---------------------------------------------------------------------------


def _launch_plan(m: int, nb: int, kind: str, split: Optional[bool] = None,
                 device=None) -> list:
    """Schedules to launch, one kernel launch each.

    The schedule carries what the reference's ``_sched_linear`` returned
    (its steps, its map and, for the ``table`` kind, the table, on the
    card as ``device_descriptor().data``).  A composite schedule splits
    into one launch per piece when ``split`` is true, or, for
    ``split=None``, when ``autotune.should_split_pieces`` says so; pieces
    cover disjoint tiles, so the launches chain on one buffer exactly.
    ``kind='auto'`` resolves for ``device``.
    """
    sched = _schedule(m, nb, kind, device)
    if sched.kind == "composite":
        subs = sched.split_pieces()
        if split is None:
            split = should_split_pieces(len(subs), sched.steps)
        if split and len(subs) > 1:
            return list(subs)
    return [sched]


def _linear_blocks(sched, device, per: int):
    """Per chunk of the linear grid: int64 ``(S, m)`` array-axis blocks
    of its valid steps, ``per`` elements of work per step."""
    step = max(1, _CHUNK_ELEMS // per)
    tab = sched.prefetch
    tab = None if tab is None else torch.from_numpy(tab).to(device)
    for s0 in range(0, sched.steps, step):
        lin = torch.arange(s0, min(sched.steps, s0 + step), dtype=torch.int64,
                           device=device)
        out = sched.map(lin) if tab is None else sched.map(lin, tab)
        v = torch.as_tensor(out[-1], device=device).to(torch.bool).expand(lin.shape)
        # math order (x_0, ..., x_{m-1}) -> array axes (x_{m-1}, ..., x_0)
        yield torch.stack([torch.as_tensor(c, device=device).to(torch.int64)[v]
                           for c in out[-2::-1]], dim=1)


def _cube_tiles(a: torch.Tensor, rho: int) -> torch.Tensor:
    """``(nb,)*m + (rho,)*m`` view of an ``(n,)*m`` array: block
    coordinates, then the tile, writable through index assignment."""
    m, nb = a.ndim, a.shape[0] // rho
    v = a.view(sum(((nb, rho) for _ in range(m)), ()))
    return v.permute(*range(0, 2 * m, 2), *range(1, 2 * m, 2))


def _simplex_tiles(blocks: torch.Tensor, rho: int, n: int) -> torch.Tensor:
    """``(S,) + (rho,)*m`` mask of ``sum of coordinates < n`` over the
    tiles of array-axis ``blocks``."""
    s, m = blocks.shape
    r = torch.arange(rho, device=blocks.device)
    total = torch.zeros((s,) + (1,) * m, dtype=torch.int64, device=blocks.device)
    for j in range(m):
        shape = [s] + [1] * m
        shape[1 + j] = rho
        total = total + (blocks[:, j, None] * rho + r).reshape(shape)
    return total < n


def _check_cube(name: str, a: torch.Tensor, m: int, rho: int, smem_bytes: int = 0) -> int:
    n = a.shape[0] if a.ndim else 0
    if a.ndim != m or tuple(a.shape) != (n,) * m:
        raise ValueError(f"{name}: expected an m-cube operand of shape (n,)*{m}, got "
                         f"{tuple(a.shape)}")
    check_tile(name, m, n, rho, smem_bytes)
    return n


def _check_linear_launch(name: str, sched, rho: int, a: torch.Tensor, dtypes,
                         smem_bytes: int = 0) -> None:
    """The m >= 3 kernels' contract, checked before any build or launch."""
    if sched.m < 3:
        raise ValueError(f"{name}: the linear grid serves m >= 3, got m={sched.m}")
    n = _check_cube(name, a, sched.m, rho, smem_bytes)
    if n != sched.n * rho:
        raise ValueError(
            f"{name}: schedule (m={sched.m}, nb={sched.n}) at rho={rho} needs a "
            f"{(sched.n * rho,) * sched.m} operand, got {tuple(a.shape)}"
        )
    card_operand(a, name, dtypes)


def _desc_args(sched, device) -> tuple:
    """The schedule's header and device payload as the C entries take them."""
    desc = sched.device_descriptor(device)
    return desc.header.ctypes.data, None if desc.data is None else desc.data.data_ptr()


def legacy_vector_access(rho: int, itemsize: int, data_ptr: int) -> bool:
    """Whether the ACCUM originals (``accum2d`` in ``legacy2d.cu``,
    ``accum3d`` and ``accum_md`` in ``legacy_md.cu``) read and write
    16-byte pieces of a tile row (else single elements): a fixed rule, true
    when a row of ``rho`` elements of ``itemsize`` bytes is a whole number
    of pieces and the array starts on a 16-byte boundary (then every tile
    row does, since ``rho`` divides the side).  ``CA2D.vector_access`` and
    ``CA3D.vector_access`` apply it to both of their buffers; ``edm2d`` to
    a point's ``d`` float32 coordinates.

    Example:
        >>> legacy_vector_access(8, 4, 0), legacy_vector_access(3, 4, 0)
        (True, False)
        >>> legacy_vector_access(12, 4, 32), legacy_vector_access(8, 4, 4)
        (True, False)
    """
    return (rho * itemsize) % 16 == 0 and data_ptr % 16 == 0


class _LinearAccum(_Legacy):
    """ACCUM over a linear grid: +1 where the coordinates sum below n.

    Attributes:
        m: The dimension the kernel serves (0: any m >= 3).
        entry: The C entry of ``legacy_md.cu``.
    """

    m = 0
    entry = ""

    def plain_(self, buf: torch.Tensor, sched, rho: int) -> None:
        """+1 on the simplex cells of each visited tile of ``buf``, in place."""
        n = buf.shape[0]
        tiles = _cube_tiles(buf, rho)
        for blk in _linear_blocks(sched, buf.device, rho ** buf.ndim):
            idx = tuple(blk.unbind(1))
            t = tiles[idx]
            tiles[idx] = torch.where(_simplex_tiles(blk, rho, n), t + 1, t)

    def kernel_(self, buf: torch.Tensor, sched, rho: int) -> None:
        """+1 on the simplex cells of each visited tile of ``buf``, in
        place (``legacy_md.cu``: 16-byte pieces where
        ``legacy_vector_access`` says so, single elements elsewhere)."""
        if self.m and sched.m != self.m:
            raise ValueError(f"{self.name}: serves m={self.m}, got a schedule of m={sched.m}")
        _check_linear_launch(self.name, sched, rho, buf, ACCUM_DTYPES)
        vec = legacy_vector_access(rho, buf.element_size(), buf.data_ptr())
        self._launch(self.entry, buf.device, buf.data_ptr(), DTYPE_CODES[buf.dtype],
                     *_desc_args(sched, buf.device), buf.shape[0], rho, int(vec))

    def run(self, x, m: int, rho: int, kind: str, split: Optional[bool],
            device: torch.device) -> torch.Tensor:
        """A copy of ``x`` through every launch of the plan."""
        buf = torch.as_tensor(x, device=device).contiguous().clone()
        n = _check_cube(self.name, buf, m, rho)
        card = on_card(buf, self.name)
        for sched in _launch_plan(m, n // rho, kind, split, buf.device):
            if card:
                self.kernel_(buf, sched, rho)
            else:
                self.plain_(buf, sched, rho)
        return buf


class Accum3DKernel(_LinearAccum):
    """ACCUM3D: +1 on T(n) = {x+y+z < n} of an ``(n, n, n)`` array,
    axes ``(z, y, x)``."""

    name = "accum3d"
    m = 3
    entry = "legacy_accum3d_launch"


class AccumMDKernel(_LinearAccum):
    """ACCUM_MD: +1 on {sum of coordinates < n} of an ``(n,)*m`` array,
    any m >= 3 (the kernel is templated on m)."""

    name = "accum_md"
    entry = "legacy_accum_md_launch"


ACCUM3D = Accum3DKernel()
ACCUM_MD = AccumMDKernel()


def accum3d(x, rho: int = 4, kind: str = "auto", split: Optional[bool] = None,
            device=None) -> torch.Tensor:
    """+1 on T(n) = {x+y+z < n}; axes (z, y, x); rho | n.

    Args:
        x: ``(n, n, n)`` array or tensor (on the card any of
            ``policy.ACCUM_DTYPES``; +1 in its own type).
        rho: Tile side.
        kind: ``'hmap'``, ``'octant'``, ``'bb'``, ``'table'`` or
            ``'composite'`` (``'hmap'`` resolves to ``'composite'`` at a
            non-power-of-two tile count), or ``'auto'``.
        split: True launches a composite schedule one piece at a time,
            False fused; None asks the autotuner.
        device: None for the card, ``'cpu'`` for the plain version.

    Returns:
        A new tensor: ``x`` with +1 on T(n), its input elsewhere; ``x``
        itself is not changed.

    Example:
        >>> accum3d(torch.zeros(4, 4, 4, dtype=torch.int32), rho=2, device="cpu").sum().item()
        20
    """
    return ACCUM3D.run(x, 3, rho, kind, split, resolve_device(device))


def accum_md(x, rho: int = 2, kind: str = "auto", split: Optional[bool] = None,
             device=None) -> torch.Tensor:
    """+1 on T(n) = {sum(coords) < n} for an m-cube input of shape (n,)*m.

    m is ``x.ndim`` (any m >= 3); array axis j holds ``x_{m-1-j}``, as in
    ``accum3d``'s ``(z, y, x)`` layout.

    Args:
        x: ``(n,)*m`` array or tensor (dtypes as ``accum3d``).
        rho: Tile side.
        kind: ``'hmap'``, ``'bb'``, ``'table'``, ``'composite'`` or ``'auto'``.
        split: True launches a composite schedule one piece at a time,
            False fused; None asks the autotuner.
        device: None for the card, ``'cpu'`` for the plain version.

    Returns:
        A new tensor: ``x`` with +1 on the simplex, its input elsewhere.

    Raises:
        ValueError: ``x`` has fewer than three dimensions.

    Example:
        >>> accum_md(torch.zeros((4,) * 4, dtype=torch.int32), rho=2, device="cpu").sum().item()
        35
    """
    device = resolve_device(device)
    m = torch.as_tensor(x).ndim
    if m < 3:
        raise ValueError("use accum2d for the 2-simplex (its grid is (w, h))")
    return ACCUM_MD.run(x, m, rho, kind, split, device)


class CA3DKernel(_Legacy):
    """CA3D: one B3/S23 step over 26 neighbours on T(n), free boundaries.

    Each tile reads its ``(rho+2)^3`` halo; a neighbour counts only if
    its true coordinate lies in ``[0, n)^3`` and in the tetrahedron.
    Cells off the domain keep their input.  One launch, never split: a
    piece would read neighbours another piece had already stepped.
    """

    name = "ca3d"
    # legacy_md.cu: warps a block at most, a shared halo's bytes at most,
    # the warps' table in front of the halo
    WARPS, BUDGET, TABLE = 8, 56 * 1024, 16 * 8

    @classmethod
    def layout(cls, rho: int, itemsize: int, vec: bool) -> dict:
        """``legacy_md.cu``'s block (``legacy_ca3d_layout``).

        Returns:
            ``pe`` cells a staging piece (16 bytes on the vector path, else
            1), ``xw`` cells a lane counts at once, ``warps`` a block (8,
            fewer where the shared halo would pass ``BUDGET``), ``rs`` the
            shared halo's row stride (the warps' tiles side by side), ``rs1``
            a one-tile slice's, ``zs`` the planes a lane walks, ``slice``
            a slice's elements (16-byte rounded), ``slots`` the slices the
            block's memory holds and ``smem`` that memory in bytes (0 where
            one slice does not fit a block).

        Example:
            >>> L = CA3DKernel.layout(8, 4, True)
            >>> [L[k] for k in ("pe", "xw", "warps", "rs", "rs1", "zs", "slice", "slots", "smem")]
            [4, 4, 8, 72, 24, 4, 2400, 3, 28928]
            >>> CA3DKernel.layout(3, 4, False)["rs1"], CA3DKernel.layout(3, 4, False)["zs"]
            (5, 1)
        """
        pe = 16 // itemsize if vec else 1
        xw = (2 if itemsize == 8 else 4) if vec else 1
        rows = (rho + 2) ** 2
        rs1 = _halo_row(rho, 1, pe, vec)
        one = -(-rows * rs1 * itemsize // 16) * 16
        for warps in range(cls.WARPS, 0, -1):
            rs = _halo_row(rho, warps, pe, vec)
            halo = -(-rows * rs * itemsize // 16) * 16
            if warps == 1 or halo <= cls.BUDGET:
                break
        vr = rho // xw
        lr, chunks = min(vr, 32), -(-vr // 32)
        zs = next((rho // s for s in range(1, rho + 1)
                   if rho % s == 0 and rho * s * chunks >= 32 // lr), 1)
        smem = cls.TABLE + halo if cls.TABLE + one <= SMEM_LIMIT else 0
        return dict(pe=pe, xw=xw, warps=warps, rs=rs, rs1=rs1, zs=zs, slice=one // itemsize,
                    slots=halo // one, smem=smem)

    @classmethod
    def smem_bytes(cls, rho: int, itemsize: int = 4, vec: bool = False) -> int:
        """The least shared memory a block of the kernel needs: the warps'
        table and one warp's ``(rho+2)^3`` halo of ``itemsize``-byte cells
        as ``layout`` lays it out."""
        rows = (rho + 2) ** 2
        return cls.TABLE + -(-rows * _halo_row(rho, 1, 16 // itemsize if vec else 1, vec)
                             * itemsize // 16) * 16

    @classmethod
    def vector_access(cls, rho: int, itemsize: int, out_ptr: int, in_ptr: int) -> bool:
        """Whether the kernel stages and stores 16-byte pieces: a fixed
        rule, ``legacy_vector_access`` for both buffers and one warp's
        slice of that layout fitting a block.

        Example:
            >>> CA3DKernel.vector_access(8, 4, 0, 64), CA3DKernel.vector_access(8, 4, 0, 4)
            (True, False)
            >>> CA3DKernel.vector_access(8, 1, 0, 0), CA3DKernel.vector_access(16, 1, 0, 0)
            (False, True)
        """
        return (legacy_vector_access(rho, itemsize, out_ptr)
                and legacy_vector_access(rho, itemsize, in_ptr)
                and cls.smem_bytes(rho, itemsize, True) <= SMEM_LIMIT)

    def plain_(self, out: torch.Tensor, inp: torch.Tensor, sched, rho: int) -> None:
        """Step the domain cells of each visited tile from ``inp`` into ``out``."""
        n = inp.shape[0]
        src, dst = _cube_tiles(inp, rho), _cube_tiles(out, rho)
        h = torch.arange(-1, rho + 1, device=inp.device)
        for blk in _linear_blocks(sched, inp.device, (rho + 2) ** 3):
            gz = (blk[:, 0, None] * rho + h)[:, :, None, None]
            gy = (blk[:, 1, None] * rho + h)[:, None, :, None]
            gx = (blk[:, 2, None] * rho + h)[:, None, None, :]
            ok = ((gz >= 0) & (gy >= 0) & (gx >= 0) & (gz < n) & (gy < n) & (gx < n)
                  & (gz + gy + gx < n))
            halo = torch.where(ok, inp[gz.clamp(0, n - 1), gy.clamp(0, n - 1),
                                       gx.clamp(0, n - 1)], 0)  # (S, rho+2, rho+2, rho+2)
            centre = halo[:, 1:-1, 1:-1, 1:-1]
            neigh = -centre
            for dz in range(3):
                for dy in range(3):
                    for dx in range(3):
                        neigh = neigh + halo[:, dz:dz + rho, dy:dy + rho, dx:dx + rho]
            alive = ((centre == 0) & (neigh == 3)) | (
                (centre == 1) & ((neigh == 2) | (neigh == 3)))
            idx = tuple(blk.unbind(1))
            dst[idx] = torch.where(_simplex_tiles(blk, rho, n), alive.to(out.dtype),
                                   src[idx])

    def kernel_(self, out: torch.Tensor, inp: torch.Tensor, sched, rho: int) -> None:
        """Step the domain cells of each visited tile from ``inp`` into
        ``out`` (``legacy_md.cu``: 16-byte pieces where ``vector_access``
        says so, single cells elsewhere); ``out`` must not alias ``inp``."""
        if sched.m != 3:
            raise ValueError(f"{self.name}: serves m=3, got a schedule of m={sched.m}")
        _check_linear_launch(self.name, sched, rho, inp, CA_DTYPES,
                             self.smem_bytes(rho, inp.element_size()))
        if out.shape != inp.shape or out.dtype != inp.dtype:
            raise ValueError(f"{self.name}: output {tuple(out.shape)} {out.dtype} and "
                             f"input {tuple(inp.shape)} {inp.dtype} differ")
        card_operand(out, self.name, CA_DTYPES)
        if out.device != inp.device or out.data_ptr() == inp.data_ptr():
            raise ValueError(f"{self.name}: the kernel reads one buffer and writes "
                             "another on the same device")
        vec = self.vector_access(rho, inp.element_size(), out.data_ptr(), inp.data_ptr())
        self._launch("legacy_ca3d_launch", inp.device, out.data_ptr(), inp.data_ptr(),
                     DTYPE_CODES[inp.dtype], *_desc_args(sched, inp.device), inp.shape[0],
                     rho, int(vec))


CA3D = CA3DKernel()


def ca3d(state, rho: int = 4, kind: str = "auto", device=None) -> torch.Tensor:
    """One 26-neighbour Game-of-Life step on T(n), free boundaries.

    Args:
        state: ``(n, n, n)`` 0/1 array (on the card any of
            ``policy.CA_DTYPES``; neighbours counted in its own type);
            cells off T(n) are dead as neighbours whatever they hold.
        rho: Tile side.
        kind: ``'hmap'``, ``'octant'``, ``'bb'``, ``'table'``,
            ``'composite'`` or ``'auto'``.
        device: None for the card, ``'cpu'`` for the plain version.

    Returns:
        The stepped state; cells off T(n) keep their input.

    Example:
        >>> s = torch.zeros(4, 4, 4, dtype=torch.int32)
        >>> s[0, 0, 1] = s[0, 1, 0] = s[1, 0, 0] = 1  # three corners of the origin
        >>> ca3d(s, rho=2, device="cpu")[0, 0, 0].item()  # born with 3 neighbours
        1
    """
    inp = torch.as_tensor(state, device=resolve_device(device)).contiguous()
    n = _check_cube(CA3D.name, inp, 3, rho, CA3D.smem_bytes(rho, inp.element_size()))
    sched = _schedule(3, n // rho, kind, inp.device)
    out = inp.clone()
    if on_card(inp, CA3D.name):
        CA3D.kernel_(out, inp, sched, rho)
    else:
        CA3D.plain_(out, inp, sched, rho)
    return out


def launch_counts() -> dict:
    """Launches of each legacy kernel since its counter was last 0.

    Example:
        >>> sorted(launch_counts())
        ['accum2d', 'accum3d', 'accum_md', 'ca2d', 'ca3d', 'edm2d', 'map2d']
    """
    return {k.name: k.launches
            for k in (MAP2D, ACCUM2D, EDM2D, CA2D, ACCUM3D, CA3D, ACCUM_MD)}
