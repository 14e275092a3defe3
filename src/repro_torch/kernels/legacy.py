"""Frozen 2-D originals — the differential baseline of the engine.

These are the port of the JAX package's ``kernels/legacy.py``: the
original per-(body, dimension) kernels that predate the
dimension-generic ``SimplexKernel`` engine (``kernels/engine.py``,
DESIGN.md §2.3).  Each launches the paper's two-dimensional ``(w, h)``
grid: block ``(wx, wy)`` goes through the schedule's map H: Z^2 -> Z^2
to its ``(column, row)`` tile, and the tile's rule runs there.

They stay independent of the engine on purpose: ``chip_smoke.py`` and
the tests hold the engine against them, so if they shared its code the
comparison would hold the engine against itself.  They share only the
schedule subsystem (``core/schedule.py`` and the m=2 map functions of
``csrc/simplex_maps.cuh``) and the device policy.  Do not add kernels
here and do not make these share code with the engine.

Each kernel has two versions of its work on one schedule:

* ``kernel*`` — the CUDA kernel of ``csrc/legacy2d.cu`` for CUDA
  tensors; it checks its operands, launches on the current stream and
  adds one to its ``launches`` counter;
* ``plain*`` — a plain PyTorch version that walks every ``(wx, wy)`` of
  the grid through the torch backend of the schedule's map and applies
  the tile's rule with tensor ops.  CPU tensors take it; on the card it
  is the kernel's reference and nothing else.

The write discipline is the reference's: ACCUM and CA keep their input
off the domain, EDM keeps its zeros seed.  The TPU kernels flushed every
grid step back through input/output aliasing; here an invalid ``bb``
step writes nothing, and CA writes a second buffer because blocks run
in no order.  ``kind='auto'`` needs the autotuner, which is not ported
yet, so the default kind is ``'hmap'``.  The m >= 3 originals
(``accum3d``, ``ca3d``, ``accum_md``) are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.schedule import SimplexSchedule, resolve_kind
from . import _build
from .policy import card_operand, check_tile, on_card, resolve_device

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
    "launch_counts",
]

# Elements per chunk of a plain version's tile gather (bounds its memory).
_CHUNK_ELEMS = 1 << 22
_KIND_CODES = {"hmap": 0, "rb": 1, "bb": 2}
_ACCUM_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3}


# ---------------------------------------------------------------------------
# schedule plumbing
# ---------------------------------------------------------------------------


def _schedule(m: int, nb: int, kind: str) -> SimplexSchedule:
    """Resolve the schedule, enforcing the legacy 2D kind restriction."""
    if m == 2 and kind in ("table", "composite"):
        raise ValueError(
            f"the 2D kernels launch a (w, h) grid; kind={kind!r} (linear "
            "walk) is only wired for the m >= 3 kernels — use kind='hmap', "
            "'rb', or 'bb'"
        )
    return SimplexSchedule(m, nb, resolve_kind(m, nb, kind))


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
    sched = _schedule(2, nb, kind)
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
        (``legacy2d.cu``)."""
        code = _check_launch(self.name, sched, rho, buf, _ACCUM_DTYPES)
        self._launch("legacy_accum2d_launch", buf.device, buf.data_ptr(),
                     _ACCUM_DTYPES[buf.dtype], code, sched.n, buf.shape[0], rho)


ACCUM2D = Accum2DKernel()


def accum2d(x, rho: int = 8, kind: str = "hmap", device=None) -> torch.Tensor:
    """+1 on the inclusive lower triangle of ``x`` (n x n, rho | n).

    Args:
        x: ``(n, n)`` array or tensor (int32, int64, float32 or float64
            on the card).
        rho: Tile side.
        kind: ``'hmap'``, ``'rb'`` or ``'bb'``.
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
    sched = _schedule(2, n // rho, kind)
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

    @staticmethod
    def smem_bytes(rho: int, d: int) -> int:
        """Shared memory of one block: row and column point blocks, each
        ``(rho, d+1)`` float32."""
        return 4 * 2 * rho * (d + 1)

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
        """Write the triangle of each visited tile of ``out`` (``legacy2d.cu``)."""
        if p.ndim != 2 or p.shape[0] != out.shape[0]:
            raise ValueError(f"{self.name}: expected ({out.shape[0]}, d) points, got "
                             f"{tuple(p.shape)}")
        code = _check_launch(self.name, sched, rho, out, (torch.float32,),
                             self.smem_bytes(rho, p.shape[1]))
        card_operand(p, self.name, (torch.float32,))
        if p.device != out.device:
            raise ValueError(f"{self.name}: points on {p.device}, output on {out.device}")
        self._launch("legacy_edm2d_launch", out.device, out.data_ptr(), p.data_ptr(),
                     p.shape[1], code, sched.n, out.shape[0], rho)


EDM2D = EDM2DKernel()


def edm2d(p, rho: int = 8, kind: str = "hmap", device=None) -> torch.Tensor:
    """``out[i, j] = ||p_i - p_j||`` on the inclusive lower triangle.

    Args:
        p: ``(n, d)`` points (float32 on the card).
        rho: Tile side.
        kind: ``'hmap'``, ``'rb'`` or ``'bb'``.
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
    sched = _schedule(2, n // rho, kind)
    out = torch.zeros((n, n), dtype=p.dtype, device=p.device)
    if on_card(out, EDM2D.name):
        EDM2D.kernel_(out, p, sched, rho)
    else:
        EDM2D.plain_(out, p, sched, rho)
    return out


# ---------------------------------------------------------------------------
# CA2D — game of life on the triangle, periodic wrap (memory-bound, halos)
# ---------------------------------------------------------------------------


class CA2DKernel(_Legacy):
    """CA: one B3/S23 step on the triangle of a periodic square.

    Each tile reads its ``(rho+2)^2`` halo, every cell masked by
    ``col <= row`` at its own wrapped position; cells off the triangle
    keep their input.
    """

    name = "ca2d"

    @staticmethod
    def smem_bytes(rho: int) -> int:
        """Shared memory of one block: the ``(rho+2)^2`` int32 halo."""
        return 4 * (rho + 2) ** 2

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
        (``legacy2d.cu``); ``out`` must not alias ``inp``."""
        code = _check_launch(self.name, sched, rho, inp, (torch.int32,),
                             self.smem_bytes(rho))
        if out.shape != inp.shape:
            raise ValueError(f"{self.name}: output {tuple(out.shape)} and input "
                             f"{tuple(inp.shape)} differ")
        card_operand(out, self.name, (torch.int32,))
        if out.device != inp.device or out.data_ptr() == inp.data_ptr():
            raise ValueError(f"{self.name}: the kernel reads one buffer and writes "
                             "another on the same device")
        self._launch("legacy_ca2d_launch", inp.device, out.data_ptr(), inp.data_ptr(),
                      code, sched.n, inp.shape[0], rho)


CA2D = CA2DKernel()


def ca2d(state, rho: int = 8, kind: str = "hmap", device=None) -> torch.Tensor:
    """One Game-of-Life step on the inclusive lower triangle (periodic
    underlying square).

    Args:
        state: ``(n, n)`` 0/1 array (int32 on the card).
        rho: Tile side.
        kind: ``'hmap'``, ``'rb'`` or ``'bb'``.
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
    n = _check_square(CA2D.name, inp, rho, CA2D.smem_bytes(rho))
    sched = _schedule(2, n // rho, kind)
    out = inp.clone()
    if on_card(inp, CA2D.name):
        CA2D.kernel_(out, inp, sched, rho)
    else:
        CA2D.plain_(out, inp, sched, rho)
    return out


# ---------------------------------------------------------------------------
# the m >= 3 originals: not ported yet
# ---------------------------------------------------------------------------


def _not_ported(name: str):
    raise NotImplementedError(
        f"legacy.{name} (the frozen m >= 3 original) is not ported yet: it is "
        "ROADMAP queue B, the next slice of the port; the engine serves m >= 3 "
        "(kernels.engine.accum / ca / accum_md)"
    )


def accum3d(x, rho: int = 4, kind: str = "hmap", split: Optional[bool] = None,
            device=None) -> torch.Tensor:
    """+1 on T(n) = {x+y+z < n}; not ported yet (raises)."""
    _not_ported("accum3d")


def ca3d(state, rho: int = 4, kind: str = "hmap", device=None) -> torch.Tensor:
    """One 26-neighbour Game-of-Life step on T(n); not ported yet (raises)."""
    _not_ported("ca3d")


def accum_md(x, rho: int = 2, kind: str = "hmap", split: Optional[bool] = None,
             device=None) -> torch.Tensor:
    """+1 on T(n) for an (n,)*m input, m >= 3; not ported yet (raises)."""
    _not_ported("accum_md")


def launch_counts() -> dict:
    """Launches of each legacy kernel since its counter was last 0.

    Example:
        >>> sorted(launch_counts())
        ['accum2d', 'ca2d', 'edm2d', 'map2d']
    """
    return {k.name: k.launches for k in (MAP2D, ACCUM2D, EDM2D, CA2D)}
