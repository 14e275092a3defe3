"""The dimension-generic ``SimplexKernel`` engine (DESIGN.md §2.3).

One launcher serves every simplex workload at every dimension: a kernel
*body* (MAP / ACCUM / EDM / CA) is combined with any
``core.schedule.SimplexSchedule`` and launched as one CUDA kernel per
launch piece, one warp per schedule step (MAP: a thread per step).  The
warp evaluates the schedule's map on its step index
(``kernels/csrc/simplex_maps.cuh``), an invalid step returns at once,
and the warp's lanes cover the ``rho^m`` tile the map names — the
paper's design (a block per step there), which on a GPU needs
none of the TPU launcher's trash tile or input/output aliasing.

Every body has two versions of its work on one schedule:

* ``kernel*`` — the hand-written CUDA kernel (``kernels/csrc``), for
  CUDA tensors.  It checks device, dtype, shape and contiguity, launches
  on the current stream without synchronising, and adds one to the
  body's ``launches`` counter.
* ``plain*`` — a plain PyTorch version of the same function that walks
  the same schedule through the torch backend of its map and gathers and
  scatters tiles with tensor ops.  CPU tensors take it; on the card it
  is the kernel's reference and nothing else.

Dispatch follows the tensor (``policy.on_card``); nothing falls back.
The write discipline is the reference's: ACCUM and CA keep their input
off the domain, EDM keeps its zeros seed.  CA reads one buffer and
writes another, because blocks run in no order.

``kind='auto'`` (the default) resolves through the autotuner for the
device the operand lives on, and ``split=None`` asks it whether to launch
a composite walk one piece at a time.  ``executor='xla'`` runs the
reference's fused executors (``kernels/compiled.py``) as torch
gather/scatter on the operand's device, for MAP and ACCUM.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..autotune.tuner import should_split_pieces
from ..core.schedule import SimplexSchedule, resolve_kind
from . import _build, compiled
from .policy import (ACCUM_DTYPES, CA_DTYPES, DTYPE_CODES, EDM_DTYPES, SMEM_LIMIT,
                     card_operand, check_tile, on_card, resolve_device)

__all__ = [
    "SimplexKernel",
    "KernelBody",
    "MapBody",
    "AccumBody",
    "EDMBody",
    "CABody",
    "register_body",
    "registered_bodies",
    "get_body",
    "launch_counts",
    "domain_mask",
    "check_operand",
    "walk",
    "schedule_for",
    "launch_plan",
    "map_table",
    "accum",
    "accum_",
    "edm",
    "ca",
    "edm2d",
    "edm3d",
    "edm_md",
    "ca_md",
    "accum_md",
    "grid_steps",
    "default_rho",
    "accum_vector_access",
]

# Elements per chunk of a plain version's tile gather (bounds its memory).
_CHUNK_ELEMS = 1 << 22
# Schedule steps (warps) a block of ca.cu takes at most (CA_WARPS there).
CA_WARPS = 8


# ---------------------------------------------------------------------------
# geometry shared by every body
# ---------------------------------------------------------------------------


def default_rho(m: int) -> int:
    """The per-dimension default tile side (the reference's defaults).

    Returns:
        8 at m=2, 4 at m=3, 2 at m >= 4.
    """
    return {2: 8, 3: 4}.get(m, 2)


def domain_mask(m: int, n: int, coords: Sequence[torch.Tensor]) -> torch.Tensor:
    """The per-element domain predicate in array-axis order.

    Args:
        m: Simplex dimension.
        n: Side length in elements.
        coords: One coordinate tensor per array axis (axis j holds math
            coordinate ``x_{m-1-j}``).

    Returns:
        Boolean mask: the m=2 inclusive lower triangle ``{col <= row}``,
        or the strict simplex ``{sum < n}`` at m >= 3.
    """
    if m == 2:
        return coords[1] <= coords[0]
    total = coords[0]
    for c in coords[1:]:
        total = total + c
    return total < n


@lru_cache(maxsize=64)
def _schedule(m: int, nb: int, kind: str) -> SimplexSchedule:
    return SimplexSchedule(m, nb, kind)


def schedule_for(m: int, nb: int, kind: str, device=None) -> SimplexSchedule:
    """The resolved schedule of ``(m, nb, kind)`` (``'auto'`` for
    ``device``, None the card), built once per concrete kind and cached,
    with it its device descriptor, built once per device."""
    return _schedule(m, nb, resolve_kind(m, nb, kind, device))


def launch_plan(m: int, nb: int, kind: str, split: Optional[bool],
                element_local: bool, schedule=None, device=None) -> list:
    """Schedules to launch, one kernel launch each.

    A composite schedule splits into one launch per piece when the body
    is element-local (pieces cover disjoint tiles) and ``split`` is true,
    or, for ``split=None``, when ``autotune.should_split_pieces`` says so.
    ``kind='auto'`` resolves for ``device``.  An explicit ``schedule``
    bypasses kind resolution and splitting.
    """
    if schedule is not None:
        if schedule.m != m or schedule.n != nb:
            raise ValueError(
                f"explicit schedule is (m={schedule.m}, nb={schedule.n}) "
                f"but the launch needs (m={m}, nb={nb})"
            )
        return [schedule]
    sched = schedule_for(m, nb, kind, device)
    if sched.kind == "composite" and element_local:
        subs = sched.split_pieces()
        if split is None:
            split = should_split_pieces(len(subs), sched.steps)
        if split and len(subs) > 1:
            return list(subs)
    return [sched]


def walk(sched, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every step of a schedule through the torch backend of its map.

    Args:
        sched: A schedule (``.grid``, ``.steps``, ``.map``, ``.prefetch``).
        device: Where to evaluate the map.

    Returns:
        ``(coords, valid)``: ``(steps, m)`` int64 math-order block
        coordinates and a ``(steps,)`` bool validity flag.
    """
    lin = torch.arange(sched.steps, dtype=torch.int64, device=device)
    ws = []
    for g in sched.grid:
        ws.append(lin % g)
        lin = lin // g
    if sched.prefetch is not None:
        ws.append(torch.from_numpy(sched.prefetch).to(device))
    out = sched.map(*ws)
    coords = torch.stack([c.to(torch.int64) for c in out[:-1]], dim=1)
    return coords, out[-1].to(torch.bool)


def _valid_blocks(sched, device) -> torch.Tensor:
    """``(S, m)`` array-axis block coordinates of the valid steps."""
    coords, valid = walk(sched, device)
    return coords[valid].flip(1)


def _tile_coords(blocks: torch.Tensor, rho: int) -> torch.Tensor:
    """``(S, rho^m, m)`` element coordinates of tiles, last axis fastest."""
    m = blocks.shape[1]
    r = torch.arange(rho, device=blocks.device)
    local = torch.stack(torch.meshgrid(*([r] * m), indexing="ij"), -1)
    return blocks[:, None, :] * rho + local.reshape(-1, m)[None]


def _offsets(g: torch.Tensor, n: int) -> torch.Tensor:
    """Row-major int64 offsets of ``(..., m)`` coordinates."""
    off = g[..., 0]
    for j in range(1, g.shape[-1]):
        off = off * n + g[..., j]
    return off


def _chunks(total: int, per: int):
    step = max(1, _CHUNK_ELEMS // max(per, 1))
    for s0 in range(0, total, step):
        yield slice(s0, min(total, s0 + step))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _cube(x: torch.Tensor, m: int, name: str) -> int:
    n = x.shape[0] if x.ndim else 0
    if tuple(x.shape) != (n,) * m:
        raise ValueError(
            f"{name}: expected an m-cube operand of shape {(n,) * m}, "
            f"got {tuple(x.shape)}"
        )
    return n


def check_operand(name: str, sched, rho: int, cube: torch.Tensor,
                  points: Optional[torch.Tensor] = None,
                  smem_bytes: int = 0) -> None:
    """Hold a kernel wrapper's operands against the schedule it walks.

    The device map writes tiles of side ``rho`` anywhere in the
    ``(sched.n * rho,)*sched.m`` cube, so a smaller or differently shaped
    buffer would be read and written out of bounds on the card.

    Args:
        name: Kernel name, for messages.
        sched: The schedule to launch (``.m``, ``.n`` in tiles).
        rho: Tile side.
        cube: The ``(n,)*m`` domain buffer.
        points: EDM only: the ``(n, d)`` point rows.
        smem_bytes: Dynamic shared memory one block needs.

    Raises:
        ValueError: on any mismatch.

    Example:
        >>> s = schedule_for(2, 4, "hmap")
        >>> check_operand("accum", s, 2, torch.zeros(8, 8))
        >>> check_operand("accum", s, 4, torch.zeros(8, 8))
        Traceback (most recent call last):
        ...
        ValueError: accum: schedule (m=2, nb=4) at rho=4 needs a (16, 16) operand, got (8, 8)
    """
    n = sched.n * rho
    if tuple(cube.shape) != (n,) * sched.m:
        raise ValueError(
            f"{name}: schedule (m={sched.m}, nb={sched.n}) at rho={rho} needs "
            f"a {(n,) * sched.m} operand, got {tuple(cube.shape)}"
        )
    if points is not None and (points.ndim != 2 or points.shape[0] != n):
        raise ValueError(
            f"{name}: expected ({n}, d) points for the schedule, got "
            f"{tuple(points.shape)}"
        )
    check_tile(name, sched.m, n, rho, smem_bytes)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# body contract
# ---------------------------------------------------------------------------


class KernelBody:
    """Base class of the body-registration contract (DESIGN.md §2.3).

    A body declares what one tile computes, as a CUDA kernel and as its
    plain PyTorch version; the engine owns the schedule walk and the
    launch plan.

    Class attributes:
        name: Registry key.
        element_local: True when per-piece launch splitting is sound
            (no tile reads another tile's cells).

    Attributes:
        launches: Kernel launches so far — one per launch of the CUDA
            kernel, never for the plain version.
    """

    name: str = ""
    element_local: bool = True

    def __init__(self):
        self.launches = 0

    def launch(self, kernel: "SimplexKernel", x, device: torch.device):
        """Run the body on operand ``x`` through ``kernel``'s plan."""
        raise NotImplementedError

    def xla_executor(self, kernel: "SimplexKernel", x, device: torch.device):
        """The reference's fused executor (``executor='xla'``); None if
        the body has none."""
        return None


_BODIES: Dict[str, KernelBody] = {}


def register_body(body: KernelBody) -> KernelBody:
    """Register a body instance under ``body.name``."""
    _BODIES[body.name] = body
    return body


def registered_bodies() -> Tuple[str, ...]:
    """Sorted names of every registered body."""
    return tuple(sorted(_BODIES))


def get_body(body) -> KernelBody:
    """Resolve a body argument (name or instance) to the instance."""
    if isinstance(body, KernelBody):
        return body
    if body not in _BODIES:
        raise ValueError(
            f"no kernel body named {body!r}; registered: {registered_bodies()}"
        )
    return _BODIES[body]


def launch_counts() -> Dict[str, int]:
    """Kernel launches per registered body since its counter was last 0.

    Example:
        >>> sorted(launch_counts())
        ['accum', 'ca', 'edm', 'map']
    """
    return {name: _BODIES[name].launches for name in registered_bodies()}


# ---------------------------------------------------------------------------
# bodies
# ---------------------------------------------------------------------------


class MapBody(KernelBody):
    """MAP: materialise the schedule walk, ``(steps, m+1)`` int32 rows
    of ``(*coords, valid)`` — the paper's map-only microbenchmark."""

    name = "map"

    def plain(self, sched, device) -> torch.Tensor:
        """The walk table through the torch backend of the map."""
        coords, valid = walk(sched, device)
        return torch.cat(
            [coords.to(torch.int32), valid[:, None].to(torch.int32)], dim=1
        )

    def kernel(self, sched, chunk: int, device) -> torch.Tensor:
        """The walk table from ``map.cu``: ``chunk`` threads a block, a few
        steps a thread, each block's rows stored as 16-byte pieces."""
        if not 1 <= chunk <= 1024:
            raise ValueError(f"map: chunk={chunk} threads must lie in 1..1024")
        device = torch.device(device)
        desc = sched.device_descriptor(device)
        out = torch.empty((sched.steps, sched.m + 1), dtype=torch.int32,
                          device=device)
        lib = _build.library()
        with torch.cuda.device(device):
            code = lib.simplex_map_launch(
                out.data_ptr(), desc.header.ctypes.data, _ptr(desc.data),
                chunk, _stream(out),
            )
        _build.check(code, "map")
        self.launches += 1
        return out

    def launch(self, kernel: "SimplexKernel", nb: int, device: torch.device):
        """The schedule of ``(kernel.m, nb, kernel.kind)`` (or
        ``kernel.schedule``) as a table on ``device``."""
        (sched,) = launch_plan(kernel.m, nb, kernel.kind, None, False,
                               schedule=kernel.schedule, device=device)
        if device.type == "cuda":
            return self.kernel(sched, kernel.chunk, device)
        if device.type != "cpu":
            raise ValueError(f"map: no kernel for {device}")
        return self.plain(sched, device)

    def xla_executor(self, kernel: "SimplexKernel", nb: int, device: torch.device):
        """The walk as one vectorised torch program
        (``compiled.schedule_coords_compiled``)."""
        kind = resolve_kind(kernel.m, nb, kernel.kind, device)
        return compiled.schedule_coords_compiled(kernel.m, nb, kind, device=device)


def accum_vector_access(rho: int, itemsize: int, data_ptr: int) -> bool:
    """Whether ``accum.cu`` reads and writes 16-byte pieces (else single
    elements): a fixed rule, true when a tile row of ``rho`` elements of
    ``itemsize`` bytes is a whole number of pieces and the array starts on
    a 16-byte boundary (then every tile row does, since ``rho`` divides
    the side).

    Example:
        >>> accum_vector_access(16, 4, 0), accum_vector_access(2, 4, 0)
        (True, False)
        >>> accum_vector_access(2, 8, 16), accum_vector_access(16, 4, 4)
        (True, False)
    """
    return (rho * itemsize) % 16 == 0 and data_ptr % 16 == 0


class AccumBody(KernelBody):
    """ACCUM: +1 on every simplex element (the memory-bound test)."""

    name = "accum"

    def plain_(self, buf: torch.Tensor, sched, rho: int) -> None:
        """+1 on the domain tiles ``sched`` visits, in place."""
        m, n = buf.ndim, buf.shape[0]
        flat = buf.view(-1)
        blocks = _valid_blocks(sched, buf.device)
        for sl in _chunks(len(blocks), rho**m):
            g = _tile_coords(blocks[sl], rho)
            off = _offsets(g, n)[domain_mask(m, n, g.unbind(-1))]
            flat[off] = flat[off] + 1

    def kernel_(self, buf: torch.Tensor, sched, rho: int) -> None:
        """+1 on the domain tiles ``sched`` visits, in place (``accum.cu``),
        in 16-byte pieces where ``accum_vector_access`` says so."""
        check_operand(self.name, sched, rho, buf)
        card_operand(buf, self.name, ACCUM_DTYPES)
        desc = sched.device_descriptor(buf.device)
        vec = accum_vector_access(rho, buf.element_size(), buf.data_ptr())
        lib = _build.library()
        with torch.cuda.device(buf.device):
            code = lib.simplex_accum_launch(
                buf.data_ptr(), DTYPE_CODES[buf.dtype], desc.header.ctypes.data,
                _ptr(desc.data), buf.shape[0], rho, int(vec), _stream(buf),
            )
        _build.check(code, self.name)
        self.launches += 1

    def run_(self, kernel: "SimplexKernel", buf: torch.Tensor) -> torch.Tensor:
        """Every launch of ``kernel``'s plan on ``buf``, in place."""
        m, rho = kernel.m, kernel.rho
        n = _cube(buf, m, self.name)
        check_tile(self.name, m, n, rho)
        card = on_card(buf, self.name)
        if not buf.is_contiguous():
            raise ValueError(f"{self.name}: in-place operand must be contiguous")
        for sched in launch_plan(m, n // rho, kernel.kind, kernel.split,
                                 self.element_local, schedule=kernel.schedule,
                                 device=buf.device):
            if card:
                self.kernel_(buf, sched, rho)
            else:
                self.plain_(buf, sched, rho)
        return buf

    def launch(self, kernel: "SimplexKernel", x, device: torch.device):
        """A copy of ``x`` with +1 on the domain; ``x`` is untouched."""
        x = torch.as_tensor(x, device=device)
        return self.run_(kernel, x.contiguous().clone())

    def xla_executor(self, kernel: "SimplexKernel", x, device: torch.device):
        """``compiled.accum2d_compiled`` at m=2, ``accum_md_compiled`` beyond."""
        x = torch.as_tensor(x, device=device)
        if kernel.m == 2:
            return compiled.accum2d_compiled(x, rho=kernel.rho, kind=kernel.kind)
        return compiled.accum_md_compiled(x, rho=kernel.rho, kind=kernel.kind)


class EDMBody(KernelBody):
    """EDM: sum of pairwise point distances per simplex cell.

    ``out[c] = sum_{a < b} ||p[c_a] - p[c_b]||`` over the cell's
    coordinates, in float32; 0 off the domain (the zeros seed).  The
    kernel runs one warp per schedule step, not one block, and takes the
    distances in the Gram form on the tensor cores (3xTF32 ``mma.sync``)
    with the difference form below its cancellation guard; the plain
    version keeps the difference form.
    """

    name = "edm"

    def plain_(self, out: torch.Tensor, p: torch.Tensor, sched, rho: int) -> None:
        """Write the domain cells of the tiles ``sched`` visits."""
        m, n = out.ndim, out.shape[0]
        pf = p.to(torch.float32)
        d = p.shape[1]
        flat = out.view(-1)
        coords, valid = walk(sched, out.device)
        coords = coords[valid]
        r = torch.arange(rho, device=out.device)
        for sl in _chunks(len(coords), max(rho**m, rho * rho * d)):
            c = coords[sl]
            s = len(c)
            ps = [pf[c[:, a, None] * rho + r] for a in range(m)]  # (S, rho, d)
            total = torch.zeros((s,) + (rho,) * m, dtype=torch.float32,
                                device=out.device)
            for a in range(m):
                for b in range(a + 1, m):
                    # (i_b, i_a) orientation: axis m-1-b < axis m-1-a.
                    d2 = ((ps[b][:, :, None, :] - ps[a][:, None, :, :]) ** 2).sum(-1)
                    shape = [s] + [1] * m
                    shape[1 + m - 1 - b] = rho
                    shape[1 + m - 1 - a] = rho
                    total = total + torch.sqrt(d2).reshape(shape)
            g = _tile_coords(c.flip(1), rho)
            keep = domain_mask(m, n, g.unbind(-1))
            flat[_offsets(g, n)[keep]] = total.reshape(s, -1)[keep].to(out.dtype)

    def kernel_(self, out: torch.Tensor, p: torch.Tensor, sched, rho: int) -> None:
        """Write the domain cells of the tiles ``sched`` visits (``edm.cu``):
        the points are staged as float32, the distances stored in
        ``out.dtype``, one of ``EDM_DTYPES``."""
        check_operand(self.name, sched, rho, out, points=p,
                      smem_bytes=self.smem_bytes(sched.m, rho, p.shape[-1]))
        card_operand(out, self.name, EDM_DTYPES)
        card_operand(p, self.name, EDM_DTYPES)
        if p.device != out.device:
            raise ValueError(f"{self.name}: points on {p.device}, output on {out.device}")
        pf = p.to(torch.float32)
        desc = sched.device_descriptor(out.device)
        lib = _build.library()
        with torch.cuda.device(out.device):
            code = lib.simplex_edm_launch(
                out.data_ptr(), DTYPE_CODES[out.dtype], pf.data_ptr(), p.shape[1],
                desc.header.ctypes.data, _ptr(desc.data), out.shape[0], rho, _stream(out),
            )
        _build.check(code, self.name)
        self.launches += 1

    @staticmethod
    def _warp_floats(m: int, rho: int, ld: int) -> int:
        f = m * rho * ld + (m * (m - 1) // 2 * rho * rho if m > 2 else 0)
        return (f + 3) & ~3

    @staticmethod
    def row_stride(m: int, rho: int, d: int) -> int:
        """Floats per staged point row in ``edm.cu``: the least ``ld >= d``
        with ``ld % 8 == 4`` (conflict-free ``mma.sync`` fragment loads),
        or ``d`` when that layout would not fit one warp's slice.

        Example:
            >>> EDMBody.row_stride(2, 16, 64), EDMBody.row_stride(3, 8, 5)
            (68, 12)
        """
        ld = d + (12 - d % 8) % 8
        return ld if 4 * EDMBody._warp_floats(m, rho, ld) <= SMEM_LIMIT else d

    @staticmethod
    def smem_bytes(m: int, rho: int, d: int) -> int:
        """Shared memory of one warp of ``edm.cu``, the least a block
        needs: its point rows at ``row_stride`` floats, then at m >= 3 the
        pair distance matrices, rounded up to 16 bytes.  A block holds as
        many such slices (up to 4 warps) as fit.

        Example:
            >>> EDMBody.smem_bytes(2, 16, 64)
            8704
        """
        return 4 * EDMBody._warp_floats(m, rho, EDMBody.row_stride(m, rho, d))

    def launch(self, kernel: "SimplexKernel", p, device: torch.device):
        """The ``(n,)*m`` distance field of points ``p`` on ``device``.

        The registered body on a schedule kind runs as one dispatcher op,
        ``torch.ops.repro_torch.edm`` (``_edm_field``), so that a dispatch
        mode sees the field as one op (its FLOP formula is registered in
        ``roofline/trace_cost.py``) and ``meta`` tensors get its shape
        without a walk.  An explicit schedule object (a shard's) cannot
        cross the dispatcher, and its walk runs here directly.
        """
        m, rho = kernel.m, kernel.rho
        p = torch.as_tensor(p, device=device)
        if p.ndim != 2:
            raise ValueError(f"edm: expected (n, d) points, got {tuple(p.shape)}")
        check_tile(self.name, m, p.shape[0], rho, self.smem_bytes(m, rho, p.shape[1]))
        if kernel.schedule is None and self is _BODIES.get(self.name):
            return _edm_field(p, m, rho, kernel.kind, kernel.split)
        return self.field(p, m, rho, kernel.kind, kernel.split, kernel.schedule)

    def field(self, p: torch.Tensor, m: int, rho: int, kind: str, split: Optional[bool],
              schedule) -> torch.Tensor:
        """The distance field of checked points ``p``, every piece of the
        launch plan of ``(m, n / rho, kind)`` (or of ``schedule``) run on
        ``p``'s device: the kernel on the card, the plain version on the
        CPU."""
        n = p.shape[0]
        out = torch.zeros((n,) * m, dtype=p.dtype, device=p.device)
        card = on_card(out, self.name)
        p = p.contiguous()
        for sched in launch_plan(m, n // rho, kind, split, self.element_local,
                                 schedule=schedule, device=out.device):
            if card:
                self.kernel_(out, p, sched, rho)
            else:
                self.plain_(out, p, sched, rho)
        return out


class CABody(KernelBody):
    """CA: one Game-of-Life step (B3/S23 analogue, 3^m - 1 neighbours).

    m=2 wraps periodically on the underlying square; m >= 3 has free
    boundaries.  Cells off the domain are dead as neighbours and keep
    their input in the output.
    """

    name = "ca"
    element_local = False

    @staticmethod
    def stencil(m: int) -> Tuple[Tuple[int, ...], ...]:
        """The element offsets one cell's update reads: itself and its
        ``3^m - 1`` neighbours (checked against ``plain_``'s reads and
        ``ca.cu``'s halo slice by ``analysis/halo_passes.py``).

        Example:
            >>> len(CABody.stencil(3)), (0, 0) in CABody.stencil(2)
            (27, True)
        """
        return tuple(itertools.product((-1, 0, 1), repeat=m))

    @staticmethod
    def boundary(m: int) -> str:
        """How a neighbour past the edge is read: ``'periodic'`` at m=2
        (the underlying square wraps), ``'free'`` beyond (dead)."""
        return "periodic" if m == 2 else "free"

    def plain_(self, out: torch.Tensor, inp: torch.Tensor, sched, rho: int) -> None:
        """Step the domain cells of the tiles ``sched`` visits from
        ``inp`` into ``out``."""
        m, n = inp.ndim, inp.shape[0]
        periodic = m == 2
        src, dst = inp.view(-1), out.view(-1)
        blocks = _valid_blocks(sched, inp.device)

        def masked(q):
            if periodic:
                q = q % n
                ok = domain_mask(m, n, q.unbind(-1))
            else:
                ok = ((q >= 0) & (q < n)).all(-1) & domain_mask(m, n, q.unbind(-1))
                q = q.clamp(0, n - 1)
            return torch.where(ok, src[_offsets(q, n)], 0)

        shifts = [
            torch.tensor(d, device=inp.device)
            for d in itertools.product((-1, 0, 1), repeat=m) if any(d)
        ]
        for sl in _chunks(len(blocks), rho**m):
            g = _tile_coords(blocks[sl], rho)
            g = g[domain_mask(m, n, g.unbind(-1))]
            centre = masked(g)
            neigh = torch.zeros_like(centre)
            for d in shifts:
                neigh = neigh + masked(g + d)
            alive = ((centre == 0) & (neigh == 3)) | (
                (centre == 1) & ((neigh == 2) | (neigh == 3))
            )
            dst[_offsets(g, n)] = alive.to(out.dtype)

    def kernel_(self, out: torch.Tensor, inp: torch.Tensor, sched, rho: int) -> None:
        """Step the domain cells of the tiles ``sched`` visits from
        ``inp`` into ``out`` (``ca.cu``), in the state's own dtype (one of
        ``CA_DTYPES``); ``out`` must not alias ``inp``.  Halo rows and
        results move in 16-byte pieces where ``vector_access`` says so."""
        size = inp.element_size()
        vec = (self.vector_access(rho, size, inp.data_ptr(), out.data_ptr())
               and self.warp_bytes(sched.m, rho, size, True) <= SMEM_LIMIT)
        check_operand(self.name, sched, rho, inp,
                      smem_bytes=self.smem_bytes(sched.m, rho, size, vec))
        if out.shape != inp.shape or out.dtype != inp.dtype:
            raise ValueError(f"ca: output {tuple(out.shape)} {out.dtype} and input "
                             f"{tuple(inp.shape)} {inp.dtype} differ")
        card_operand(out, self.name, CA_DTYPES)
        card_operand(inp, self.name, CA_DTYPES)
        if out.data_ptr() == inp.data_ptr():
            raise ValueError("ca: the kernel reads one buffer and writes another")
        desc = sched.device_descriptor(inp.device)
        lib = _build.library()
        with torch.cuda.device(inp.device):
            code = lib.simplex_ca_launch(
                out.data_ptr(), inp.data_ptr(), DTYPE_CODES[inp.dtype], int(inp.ndim == 2),
                int(vec), desc.header.ctypes.data, _ptr(desc.data), inp.shape[0], rho,
                _stream(inp),
            )
        _build.check(code, self.name)
        self.launches += 1

    @staticmethod
    def vector_access(rho: int, itemsize: int, *data_ptrs: int) -> bool:
        """Whether ``ca.cu`` moves 16-byte pieces (else single cells): the
        rule of ``accum_vector_access`` on every buffer it touches.

        Example:
            >>> CABody.vector_access(16, 4, 0, 512), CABody.vector_access(16, 4, 0, 4)
            (True, False)
        """
        return all(accum_vector_access(rho, itemsize, p) for p in data_ptrs)

    @staticmethod
    def warp_bytes(m: int, rho: int, itemsize: int, vector: bool) -> int:
        """One warp's halo slice in ``ca.cu``: ``(rho+2)^(m-1)`` rows of
        ``rho + 2L`` cells (``L`` = the cells of a 16-byte piece on the
        vector path, else 1), rounded up to 16 bytes.

        Example:
            >>> CABody.warp_bytes(2, 16, 4, True), CABody.warp_bytes(2, 16, 4, False)
            (1728, 1296)
        """
        lead = 16 // itemsize if vector else 1
        return -(-((rho + 2) ** (m - 1) * (rho + 2 * lead) * itemsize) // 16) * 16

    @staticmethod
    def smem_bytes(m: int, rho: int, itemsize: int = 4, vector: bool = False) -> int:
        """Shared memory of one ``ca.cu`` block: ``CA_WARPS`` warps'
        halo slices (``warp_bytes``), fewer where they would not fit
        ``SMEM_LIMIT``, never fewer than one.

        Example:
            >>> CABody.smem_bytes(2, 16), CABody.smem_bytes(2, 16, 1, True)
            (10368, 6912)
        """
        w = CABody.warp_bytes(m, rho, itemsize, vector)
        return max(1, min(CA_WARPS, SMEM_LIMIT // w)) * w

    def launch(self, kernel: "SimplexKernel", state, device: torch.device):
        """The stepped state; off-domain cells keep their input."""
        m, rho = kernel.m, kernel.rho
        inp = torch.as_tensor(state, device=device).contiguous()
        n = _cube(inp, m, self.name)
        check_tile(self.name, m, n, rho, self.smem_bytes(m, rho, inp.element_size()))
        out = inp.clone()
        card = on_card(inp, self.name)
        for sched in launch_plan(m, n // rho, kernel.kind, kernel.split,
                                 self.element_local, schedule=kernel.schedule,
                                 device=inp.device):
            if card:
                self.kernel_(out, inp, sched, rho)
            else:
                self.plain_(out, inp, sched, rho)
        return out


register_body(AccumBody())
register_body(EDMBody())
register_body(CABody())
register_body(MapBody())


@torch.library.custom_op("repro_torch::edm", mutates_args=())
def _edm_field(p: torch.Tensor, m: int, rho: int, kind: str,
               split: Optional[bool]) -> torch.Tensor:
    """The registered EDM body's distance field of points ``p`` (checked
    by ``EDMBody.launch``) as one dispatcher op."""
    return _BODIES["edm"].field(p, m, rho, kind, split, None)


@_edm_field.register_fake
def _edm_field_shape(p, m, rho, kind, split) -> torch.Tensor:
    return p.new_zeros((p.shape[0],) * m)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


class SimplexKernel:
    """One launcher for every (body, dimension, schedule kind).

    Args:
        body: Registered body name ('map' | 'accum' | 'edm' | 'ca') or
            a ``KernelBody`` instance.
        m: Simplex dimension (m >= 2).
        rho: Tile side (default ``default_rho(m)``).
        kind: Schedule kind, ``'auto'`` for the autotuner's pick on the
            operand's device.
        split: True launches a composite schedule one piece at a time
            (element-local bodies), False fused; None asks
            ``autotune.should_split_pieces``.
        chunk: MAP body only — threads (steps) per block.
        executor: ``'kernel'`` (default) or ``'xla'``: the reference's
            fused executors (``kernels/compiled.py``) as torch ops on the
            operand's device, for MAP and ACCUM; other bodies raise
            ``NotImplementedError``, as in the reference.
        schedule: An explicit schedule object to launch instead of
            resolving ``kind``; must match the operand's (m, nb).
        device: None for the card (raises without one), or a device;
            ``'cpu'`` runs the plain PyTorch versions.

    Example:
        >>> import numpy as np
        >>> k = SimplexKernel("accum", m=3, rho=2, kind="table", device="cpu")
        >>> int(k(np.zeros((4, 4, 4), np.int32)).sum())  # V(T(4)) cells
        20
    """

    def __init__(self, body, m: int, *, rho: Optional[int] = None,
                 kind: str = "auto", split: Optional[bool] = None,
                 chunk: int = 128, executor: str = "kernel", schedule=None,
                 device=None):
        if m < 2:
            raise ValueError(f"m must be >= 2, got {m}")
        if executor not in ("kernel", "xla"):
            raise ValueError(f"unknown executor {executor!r}")
        self.body = get_body(body)
        self.m = m
        self.rho = default_rho(m) if rho is None else rho
        self.kind = kind
        self.split = split
        self.chunk = chunk
        self.executor = executor
        self.schedule = schedule
        self.device = device

    def __call__(self, x):
        """Launch the body on operand ``x`` (domain array, points, or
        tile count for the MAP body)."""
        device = resolve_device(self.device)
        if self.executor == "xla":
            out = self.body.xla_executor(self, x, device)
            if out is None:
                raise NotImplementedError(
                    f"body {self.body.name!r} has no fused executor; use "
                    "executor='kernel'"
                )
            return out
        return self.body.launch(self, x, device)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"SimplexKernel(body={self.body.name!r}, m={self.m}, "
            f"rho={self.rho}, kind={self.kind!r})"
        )


# ---------------------------------------------------------------------------
# functional entry points (what ops.py and users call)
# ---------------------------------------------------------------------------


def map_table(nb: int, m: int = 2, kind: str = "hmap", chunk: int = 128,
              device=None, executor: str = "kernel") -> torch.Tensor:
    """The MAP test at any dimension: ``(steps, m+1)`` int32
    ``(*coords, valid)`` per grid step.

    Example:
        >>> map_table(2, device="cpu").tolist()
        [[0, 0, 1], [0, 1, 1], [1, 1, 1]]
    """
    return SimplexKernel("map", m, kind=kind, chunk=chunk, device=device,
                         executor=executor)(nb)


def accum(x, rho: Optional[int] = None, kind: str = "auto",
          split: Optional[bool] = None, device=None,
          executor: str = "kernel") -> torch.Tensor:
    """+1 on every simplex element of the m-cube ``x`` (m = x.ndim).

    Args:
        x: ``(n,)*m`` array or tensor, ``rho | n``; m=2 uses the
            inclusive lower triangle, m >= 3 the strict simplex.  On the
            card any of ``policy.ACCUM_DTYPES`` (int8, uint8, int16,
            int32, int64, bfloat16, float16, float32, float64); +1 in
            the array's own type (integers wrap, 16-bit floats round to
            nearest even).
        rho: Tile side (default per dimension).
        kind: Schedule kind or ``'auto'``.
        split: Composite per-piece launches (None = autotuned).
        device: None for the card, ``'cpu'`` for the plain version.
        executor: 'kernel' or 'xla' (the fused torch executor).

    Returns:
        A new tensor: ``x`` with +1 on the domain, its input elsewhere.
    """
    return SimplexKernel("accum", x.ndim, rho=rho, kind=kind, split=split,
                         device=device, executor=executor)(x)


def accum_(x: torch.Tensor, rho: Optional[int] = None, kind: str = "auto",
           split: Optional[bool] = None) -> torch.Tensor:
    """In-place ``accum``: +1 on the domain of ``x`` itself, where it lies.

    The paper's ACCUM test as timed: each domain element is read and
    written once, with no copy.

    Returns:
        ``x``.
    """
    body = get_body("accum")
    kernel = SimplexKernel(body, x.ndim, rho=rho, kind=kind, split=split,
                           device=x.device)
    return body.run_(kernel, x)


def edm(p, m: int = 2, rho: Optional[int] = None, kind: str = "auto",
        split: Optional[bool] = None, device=None) -> torch.Tensor:
    """Pairwise-distance field over the m-simplex: the EDM test.

    ``out[c] = sum_{a<b} ||p[c_a] - p[c_b]||`` — the Euclidean distance
    matrix at m=2, its dimension-generic sibling beyond.

    Args:
        p: ``(n, d)`` points (float16, bfloat16, float32 or float64 on
            the card); the distances are computed in float32.
        m: Simplex dimension of the output field.
        rho: Tile side (default per dimension).
        kind: Schedule kind or ``'auto'``.
        split: Composite per-piece launches (None = autotuned).
        device: None for the card, ``'cpu'`` for the plain version.

    Returns:
        ``(n,)*m`` tensor in ``p.dtype``; 0 outside the domain.
    """
    return SimplexKernel("edm", m, rho=rho, kind=kind, split=split,
                         device=device)(p)


def ca(state, rho: Optional[int] = None, kind: str = "auto",
       device=None) -> torch.Tensor:
    """One Game-of-Life step on the m-simplex (m = state.ndim).

    Args:
        state: ``(n,)*m`` 0/1 array (on the card any of
            ``policy.CA_DTYPES``: int8, uint8, int16, int32, int64,
            bfloat16, float16, float32); neighbours are counted in its
            own dtype.
        rho: Tile side (default per dimension).
        kind: Schedule kind or ``'auto'``.
        device: None for the card, ``'cpu'`` for the plain version.

    Returns:
        The stepped state; out-of-domain elements keep their input.
    """
    return SimplexKernel("ca", state.ndim, rho=rho, kind=kind,
                         device=device)(state)


def edm2d(p, rho: Optional[int] = None, kind: str = "auto",
          device=None) -> torch.Tensor:
    """The m=2 EDM — ``out[i, j] = ||p_i - p_j||`` on the inclusive
    lower triangle (see ``edm``)."""
    return edm(p, 2, rho=rho, kind=kind, device=device)


def edm3d(p, rho: Optional[int] = None, kind: str = "auto",
          split: Optional[bool] = None, device=None) -> torch.Tensor:
    """The m=3 EDM: per-cell triangle perimeter on T(n) (see ``edm``)."""
    return edm(p, 3, rho=rho, kind=kind, split=split, device=device)


def edm_md(p, m: int, rho: Optional[int] = None, kind: str = "auto",
           split: Optional[bool] = None, device=None) -> torch.Tensor:
    """The general-m EDM (m >= 3; ``edm2d`` serves the triangle)."""
    if m < 3:
        raise ValueError("edm_md serves m >= 3; use edm2d for the triangle")
    return edm(p, m, rho=rho, kind=kind, split=split, device=device)


def ca_md(state, rho: Optional[int] = None, kind: str = "auto",
          device=None) -> torch.Tensor:
    """The general-m CA: (3^m - 1)-neighbour Game of Life on T(n), free
    boundaries (m = state.ndim >= 3; ``ca`` at m=2 wraps)."""
    if state.ndim < 3:
        raise ValueError("ca_md serves m >= 3; use ca for the 2-simplex")
    return ca(state, rho=rho, kind=kind, device=device)


def accum_md(x, rho: Optional[int] = None, kind: str = "auto",
             split: Optional[bool] = None, device=None) -> torch.Tensor:
    """The general-m ACCUM (m = x.ndim >= 3; see ``accum``)."""
    if x.ndim < 3:
        raise ValueError("accum_md serves m >= 3; use accum at m=2")
    return accum(x, rho=rho, kind=kind, split=split, device=device)


def grid_steps(nb: int, kind: str, m: int = 2, device=None) -> int:
    """Grid steps the engine launches for ``(m, nb, kind)`` after
    kernel-facing kind resolution (``'auto'`` for ``device``).

    Example:
        >>> grid_steps(16, "hmap"), grid_steps(16, "bb")
        (136, 256)
    """
    return schedule_for(m, nb, kind, device).steps

