"""Grid schedules: how a CUDA launch walks an m-simplex domain.

On a GPU the paper's thread map is literally the ``blockIdx -> data
block`` function of a launch (DESIGN.md §2): block ``i`` of a linear
grid evaluates H(i) and works on the tile it names.  A
``SimplexSchedule(m, n, kind)`` is that function plus its grid; a
registry keyed by (dimension, kind) resolves the walk, and every
schedule exposes the same surface (DESIGN.md §2.2)::

    .grid    grid dimensions (tuple; axis 0 fastest when linearised)
    .steps   total grid steps (the paper's "parallel space")
    .useful  simplex cells the walk must cover, V(Delta^m_n)
    .map     (*w) -> (*coords, valid); numpy or torch
    .table() host-side (steps, m+1) int32 walk table
    .waste() steps/useful - 1
    .device_descriptor(device)  the walk packed for the CUDA map

Registered kinds
----------------
* m=2: ``hmap`` (zero-waste H grid), ``rb`` (RB fold [37]), ``bb``
  (bounding box + predicate), ``table`` (device int32 table),
  ``composite`` (general-n pieces, zero waste at m=2).
* m=3: ``hmap``/``octant`` (r=1/2, beta=3 recursion, ~20% waste),
  ``table``, ``bb``, ``composite``.
* m>=4: ``hmap`` (orthant recursion), ``table``, ``bb``, ``composite``.

``kind='auto'`` asks the autotuner (``autotune.choose_kind``) through
``resolve_kind``, for the device the kernel runs on.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import hmap as H
from .general_m import alpha_extra_space, best_r_beta
from .maps_baseline import rb_map2
from .simplex import enumerate_simplex, simplex_volume, tet, tri
from .trapezoids import composite_map, decompose_simplex, pack_pieces, piece_map

__all__ = [
    "SimplexSchedule",
    "Schedule2D",
    "DeviceDescriptor",
    "register_schedule",
    "registered_kinds",
    "resolve_kind",
    "step_grid_indices",
    "schedule2d_table",
    "schedule3d_table",
    "folded_causal_pairs",
    "grid_steps",
    "MAP_CODES",
    "HEADER_LEN",
    "MAX_LEVELS",
    "SHARD_AT",
    "launch_header",
]

# Map codes of the device descriptor; kernels/csrc/simplex_maps.cuh
# holds the same numbers.
MAP_CODES = {
    "hmap2": 0, "rb2": 1, "bb2": 2, "bbmd": 3, "hrec": 4,
    "composite": 5, "table": 6,
}
MAX_LEVELS = 30
# header: kind, m, n, steps, w, K, npieces, flip, prefix[31], side[30],
# then from SHARD_AT the launch: its steps, a0, l0, a1.  Launch step lin
# walks the schedule's step lin < l0 ? a0 + lin : a1 + (lin - l0), so a
# shard of the walk (at most two ranges of its steps) reuses the walk's
# descriptor; the whole walk is (steps, 0, steps, 0).
SHARD_AT = 8 + (MAX_LEVELS + 1) + MAX_LEVELS
HEADER_LEN = SHARD_AT + 4


def step_grid_indices(sched) -> Tuple[np.ndarray, ...]:
    """Per-axis grid indices of every step (grid axis 0 fastest).

    The linearisation every kernel uses: step ``lin`` of an m=2
    ``(w, h)`` grid is ``(lin % w, lin // w)``.

    Args:
        sched: Any schedule exposing ``.grid`` and ``.steps``.

    Returns:
        One int64 array of length ``sched.steps`` per grid axis.

    Example:
        >>> ws = step_grid_indices(SimplexSchedule(2, 4, "hmap"))
        >>> len(ws), ws[0].shape
        (2, (10,))
    """
    lin = np.arange(sched.steps, dtype=np.int64)
    ws = []
    for g in sched.grid:
        ws.append(lin % g)
        lin = lin // g
    return tuple(ws)


@dataclass(frozen=True)
class DeviceDescriptor:
    """A schedule packed for the CUDA map (``simplex_maps.cuh``).

    Attributes:
        header: ``(HEADER_LEN,)`` int64 host array — map code, m, n,
            steps, grid width, recursion levels with their prefix and
            sides, piece count and the m=2 flip flag.
        data: int32 device tensor of the table (``table`` kind) or the
            packed pieces (``composite``), else None.
    """

    header: np.ndarray
    data: Optional[torch.Tensor]


@dataclass(frozen=True)
class _Spec:
    """Resolved schedule: what a kernel needs to launch the walk."""

    grid: Tuple[int, ...]
    map_fn: Callable  # (*w[, table]) -> (*coords, valid)
    useful: int
    code: str  # device map code (MAP_CODES key)
    table_builder: Optional[Callable[[], np.ndarray]] = field(default=None)
    alpha: Optional[float] = field(default=None)
    pieces: Optional[List] = field(default=None)


_REGISTRY: Dict[Tuple[Optional[int], str], Callable[[int, int], _Spec]] = {}


def register_schedule(m: Optional[int], kind: str):
    """Register a schedule builder for a (dimension, kind) pair.

    Args:
        m: Exact dimension the builder serves, or ``None`` for a
            dimension-generic fallback.
        kind: Schedule kind name.

    Returns:
        A decorator that records ``builder(m, n) -> _Spec``.

    Example:
        >>> "hmap" in registered_kinds(2)
        True
    """

    def _deco(builder):
        _REGISTRY[(m, kind)] = builder
        return builder

    return _deco


def registered_kinds(m: int) -> Tuple[str, ...]:
    """Kinds available for dimension m (exact + generic registrations).

    Example:
        >>> registered_kinds(4)
        ('bb', 'composite', 'hmap', 'table')
    """
    kinds = {k for mm, k in _REGISTRY if mm == m or mm is None}
    return tuple(sorted(kinds))


def resolve_kind(m: int, n: int, kind: str, device=None) -> str:
    """Kernel-facing kind resolution (the §4.1 power-of-two constraint).

    'hmap' needs a power-of-two tile count.  At m >= 3 a non-pow2 n
    resolves the recursion to ``'composite'``; at m = 2 it falls back to
    RB (even n) or BB (odd n).  ``'auto'`` asks the autotuner
    (``autotune.choose_kind``) for the device the kernel runs on, so a
    decision made for the CPU never serves the card.

    Args:
        m: Simplex dimension of the kernel's domain.
        n: Tile count per side.
        kind: Requested schedule kind, or ``'auto'``.
        device: Where the kernel runs, for ``'auto'``; None is the card.

    Returns:
        The kind actually constructible at this (m, n).

    Example:
        >>> resolve_kind(3, 6, "hmap"), resolve_kind(4, 100, "hmap")
        ('composite', 'composite')
        >>> resolve_kind(4, 16, "hmap"), resolve_kind(2, 6, "hmap")
        ('hmap', 'rb')
    """
    if kind == "auto":
        from ..autotune.tuner import choose_kind

        kind = choose_kind(m, n, device).kind
    pow2 = n >= 2 and (n & (n - 1)) == 0
    if m == 2:
        if kind == "hmap" and not pow2:
            kind = "rb" if n % 2 == 0 else "bb"
        if kind == "rb" and n % 2 != 0:
            kind = "bb"
        return kind
    if kind in ("hmap", "octant") and not pow2:
        return "composite"
    return kind


def launch_header(header: np.ndarray, ranges) -> np.ndarray:
    """A copy of ``header`` that launches only ``ranges`` of its walk.

    Args:
        header: A descriptor's ``(HEADER_LEN,)`` int64 header.
        ranges: One or two half-open ``(start, stop)`` ranges of the
            walk's step order, launched in that order.

    Returns:
        The header with the launch slots from ``SHARD_AT`` set.

    Example:
        >>> h = SimplexSchedule(2, 4, "hmap").device_descriptor("cpu").header
        >>> launch_header(h, ((0, 2), (8, 10)))[SHARD_AT:].tolist()
        [4, 0, 2, 8]
    """
    (a0, b0), *rest = ranges
    if len(rest) > 1:
        raise ValueError(f"a launch walks at most two ranges, got {ranges}")
    a1, b1 = rest[0] if rest else (b0, b0)
    steps = int(header[3])
    if not (0 <= a0 <= b0 <= steps and 0 <= a1 <= b1 <= steps):
        raise ValueError(f"ranges {ranges} leave the walk's {steps} steps")
    hdr = header.copy()
    hdr[SHARD_AT:] = [(b0 - a0) + (b1 - a1), a0, b0 - a0, a1]
    return hdr


def _header(code: str, m: int, n: int, steps: int, w: int = 0,
            levels=None, npieces: int = 0, flip: bool = False) -> np.ndarray:
    hdr = np.zeros(HEADER_LEN, dtype=np.int64)
    hdr[:8] = [MAP_CODES[code], m, n, steps, w, 0, npieces, int(flip)]
    hdr[SHARD_AT:] = [steps, 0, steps, 0]
    if levels is not None:
        prefix, sides = levels
        if len(sides) > MAX_LEVELS:
            raise ValueError(f"{len(sides)} recursion levels exceed {MAX_LEVELS}")
        hdr[5] = len(sides)
        hdr[8:8 + len(prefix)] = prefix
        hdr[8 + MAX_LEVELS + 1:8 + MAX_LEVELS + 1 + len(sides)] = sides
    return hdr


def _check_steps(steps: int) -> None:
    if steps >= 2**31:
        raise ValueError(
            f"{steps} grid steps exceed the int32 block index of a launch"
        )


class SimplexSchedule:
    """A grid walk over the discrete m-simplex of side n (in tile units).

    Args (constructor):
        m: Simplex dimension, m >= 2.
        n: Side length in tile units (any n >= 1 for ``composite``/
            ``table``/``bb``; power-of-two for the ``hmap`` recursions).
        kind: Registered kind name; see ``registered_kinds(m)``.

    Example:
        >>> sched = SimplexSchedule(3, 6, "composite")  # non-pow2 n
        >>> sched.steps, sched.useful, round(sched.waste(), 3)
        (72, 56, 0.286)
        >>> sched.table().shape  # (steps, m+1): (*coords, valid)
        (72, 4)
    """

    def __init__(self, m: int, n: int, kind: str = "hmap"):
        builder = _REGISTRY.get((m, kind)) or _REGISTRY.get((None, kind))
        if builder is None or m < 2:
            raise ValueError(
                f"no schedule registered for m={m}, kind={kind!r}; "
                f"available: {registered_kinds(m) if m >= 2 else ()}"
            )
        self.m = m
        self.n = n
        self.kind = kind
        self._spec = builder(m, n)
        self._table_cache: Optional[np.ndarray] = None
        self._pieces_cache: Optional[Tuple] = None
        self._desc_cache: Dict[str, DeviceDescriptor] = {}

    @property
    def grid(self) -> Tuple[int, ...]:
        """Grid dimensions to launch (``(w, h)`` for 2-D walks, else linear)."""
        return self._spec.grid

    @property
    def steps(self) -> int:
        """Total grid steps — the paper's "parallel space" (O(1) arithmetic)."""
        return math.prod(self._spec.grid)

    @property
    def useful(self) -> int:
        """Simplex cells the walk must cover, ``V(Delta^m_n)``."""
        return self._spec.useful

    @property
    def needs_table(self) -> bool:
        """True when this kind walks a host-built table."""
        return self._spec.table_builder is not None

    @property
    def prefetch(self) -> Optional[np.ndarray]:
        """The ``(steps, m)`` int32 table of table-driven walks (else None).

        Built on first access and cached, so ``.steps``/``.waste()`` stay
        O(1) arithmetic for table kinds at large n.
        """
        if self._spec.table_builder is None:
            return None
        if self._table_cache is None:
            self._table_cache = self._spec.table_builder()
        return self._table_cache

    def map(self, *w):
        """Map grid coordinates to data-tile coordinates.

        Args:
            *w: One index array (numpy or torch) per grid axis, fastest
                axis first; for table kinds the table last, of the same
                backend.

        Returns:
            ``(*coords, valid)`` — m data coordinates plus the validity
            flag.

        Example:
            >>> s = SimplexSchedule(2, 4, "hmap")
            >>> x, y, v = s.map(np.arange(2), np.zeros(2, np.int64))
            >>> x.tolist(), y.tolist(), v.tolist()
            ([0, 1], [0, 1], [True, True])
        """
        return self._spec.map_fn(*w)

    def waste(self) -> float:
        """Measured extra parallel space, ``steps/useful - 1``.

        Example:
            >>> SimplexSchedule(2, 100, "composite").waste()
            0.0
        """
        return self.steps / self.useful - 1.0

    def asymptotic_waste(self) -> Optional[float]:
        """inf-n extra-space fraction of this kind (None if unknown)."""
        return self._spec.alpha

    def table(self) -> np.ndarray:
        """(steps, m+1) int32 walk table: (*coords, valid) per grid step.

        Step order is the kernels' linearisation: grid axis 0 fastest.
        """
        if self.needs_table:
            tab = self.prefetch
            valid = np.ones((len(tab), 1), dtype=np.int32)
            return np.concatenate([tab.astype(np.int32), valid], axis=1)
        out = self.map(*step_grid_indices(self))
        cols = [np.asarray(c) for c in out[:-1]]
        cols.append(np.asarray(out[-1]).astype(np.int64))
        return np.stack(cols, axis=1).astype(np.int32)

    def split_pieces(self) -> Tuple[object, ...]:
        """Per-piece sub-schedules of a composite walk (one launch each).

        Returns:
            Tuple of per-piece schedules for ``kind='composite'``;
            ``(self,)`` for every other kind.

        Example:
            >>> subs = SimplexSchedule(3, 6, "composite").split_pieces()
            >>> sum(s.steps for s in subs)
            72
        """
        if self.kind != "composite":
            return (self,)
        if self._pieces_cache is None:
            self._pieces_cache = tuple(
                _PieceSchedule(self.m, self.n, p, i)
                for i, p in enumerate(self._spec.pieces)
            )
        return self._pieces_cache

    def device_descriptor(self, device) -> DeviceDescriptor:
        """The walk packed for the CUDA map, built once per device.

        Args:
            device: Where the descriptor's int32 payload (table or
                packed pieces) lives.

        Returns:
            A ``DeviceDescriptor``.

        Example:
            >>> d = SimplexSchedule(3, 8, "octant").device_descriptor("cpu")
            >>> d.header[:6].tolist(), d.data is None
            ([4, 3, 8, 160, 0, 3], True)
        """
        key = str(torch.device(device))
        if key not in self._desc_cache:
            self._desc_cache[key] = self._describe(torch.device(device))
        return self._desc_cache[key]

    def _describe(self, device: torch.device) -> DeviceDescriptor:
        spec, m, n = self._spec, self.m, self.n
        _check_steps(self.steps)
        w = spec.grid[0] if len(spec.grid) == 2 else 0
        data = None
        levels = None
        npieces = 0
        if spec.code == "table":
            data = torch.from_numpy(np.ascontiguousarray(self.prefetch, np.int32))
        elif spec.code == "composite":
            npieces = len(spec.pieces)
            data = torch.from_numpy(pack_pieces(spec.pieces, m))
        elif spec.code == "hrec":
            levels = H.recursive_levels(n, m)
        hdr = _header(spec.code, m, n, self.steps, w=w, levels=levels,
                      npieces=npieces, flip=(m == 2 and spec.code == "composite"))
        if data is not None:
            data = data.to(device)
        return DeviceDescriptor(hdr, data)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"SimplexSchedule(m={self.m}, n={self.n}, kind={self.kind!r}, "
            f"grid={self.grid}, steps={self.steps}, useful={self.useful})"
        )


class _PieceSchedule:
    """One piece of a split composite schedule (see ``split_pieces``).

    The subset of the ``SimplexSchedule`` surface a launch consumes:
    ``.grid``, ``.steps``, ``.useful``, ``.map`` (piece-local linear
    index -> global coords + valid), ``.prefetch`` (always None) and
    ``.device_descriptor``: a one-piece composite descriptor.
    """

    kind = "composite-piece"
    needs_table = False
    prefetch = None

    def __init__(self, m: int, n: int, piece, index: int):
        self.m = m
        self.n = n
        self.piece = piece
        self.index = index
        self.grid = (piece.grid_cells,)
        self.steps = piece.grid_cells
        self.useful = piece.data_cells
        self._desc_cache: Dict[str, DeviceDescriptor] = {}

    def map(self, lin):
        """Piece-local linear index -> ``(*coords, valid)`` (global)."""
        out = piece_map(self.piece, self.m, lin)
        if self.m != 2:
            return out
        u, v, ok = out
        return u, (self.n - 1) - v, ok  # match the m=2 composite flip

    def device_descriptor(self, device) -> DeviceDescriptor:
        """This piece as a one-piece composite descriptor (cached)."""
        key = str(torch.device(device))
        if key not in self._desc_cache:
            _check_steps(self.steps)
            hdr = _header("composite", self.m, self.n, self.steps,
                          npieces=1, flip=self.m == 2)
            data = torch.from_numpy(pack_pieces([self.piece], self.m))
            self._desc_cache[key] = DeviceDescriptor(hdr, data.to(key))
        return self._desc_cache[key]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"_PieceSchedule(m={self.m}, n={self.n}, piece={self.index}, "
            f"steps={self.steps})"
        )


def _ones_like(x):
    if isinstance(x, torch.Tensor):
        return torch.ones_like(x, dtype=torch.bool)
    return np.ones_like(np.asarray(x), dtype=bool)


def _table_fn(m: int):
    def fn(lin, tab):
        return tuple(tab[lin, j] for j in range(m)) + (_ones_like(lin),)

    return fn


# ---------------------------------------------------------------------------
# 2-simplex builders
# ---------------------------------------------------------------------------


@register_schedule(2, "hmap")
def _build2_hmap(m: int, n: int) -> _Spec:
    if n < 2 or n & (n - 1):
        raise ValueError(
            f"hmap needs a power-of-two n (paper §4.1), got {n}; use "
            "resolve_kind or the composite kind for general n"
        )

    def fn(wx, wy):
        x, y = H.hmap2_full(wx, wy, n)
        return x, y, _ones_like(x)

    return _Spec((n // 2, n + 1), fn, tri(n), "hmap2", alpha=0.0)


@register_schedule(2, "rb")
def _build2_rb(m: int, n: int) -> _Spec:
    if n < 2 or n % 2:
        raise ValueError(f"the RB fold needs an even n >= 2, got {n}")

    def fn(wx, wy):
        x, y = rb_map2(wx, wy, n)
        return x, y, _ones_like(x)

    return _Spec((n // 2, n + 1), fn, tri(n), "rb2", alpha=0.0)


@register_schedule(2, "bb")
def _build2_bb(m: int, n: int) -> _Spec:
    def fn(wx, wy):
        return wx, wy, wx <= wy

    return _Spec((n, n), fn, tri(n), "bb2", alpha=1.0)


@register_schedule(2, "table")
def _build2_table(m: int, n: int) -> _Spec:
    return _Spec((tri(n),), _table_fn(2), tri(n), "table",
                 table_builder=lambda: schedule2d_table(n), alpha=0.0)


# ---------------------------------------------------------------------------
# 3-simplex and general-m builders
# ---------------------------------------------------------------------------


@register_schedule(3, "table")
def _build3_table(m: int, n: int) -> _Spec:
    return _Spec((tet(n),), _table_fn(3), tet(n), "table",
                 table_builder=lambda: schedule3d_table(n), alpha=0.0)


def _build_md_hmap(m: int, n: int) -> _Spec:
    inv_r, beta = best_r_beta(m, constructible=True)
    steps = H.hmap_m_grid_size(n, m, inv_r, beta)

    def fn(lin):
        return H.hmap_m_recursive(lin, n, m, inv_r, beta)

    return _Spec((steps,), fn, simplex_volume(n, m), "hrec",
                 alpha=alpha_extra_space(m, inv_r, beta))


register_schedule(None, "hmap")(_build_md_hmap)
register_schedule(3, "octant")(_build_md_hmap)


@register_schedule(None, "table")
def _build_md_table(m: int, n: int) -> _Spec:
    v = simplex_volume(n, m)
    return _Spec((v,), _table_fn(m), v, "table",
                 table_builder=lambda: enumerate_simplex(n, m).astype(np.int32),
                 alpha=0.0)


@register_schedule(None, "composite")
def _build_composite(m: int, n: int) -> _Spec:
    """General-n composite schedule: pow2 core + shell pieces, one grid.

    At m=2 the strict-sum coordinates are flipped into the (col, row)
    lower-triangle convention; every m=2 factor has dim <= 2, so the
    m=2 composite is zero waste.
    """
    pieces = decompose_simplex(m, n)
    steps = sum(p.grid_cells for p in pieces)

    if m == 2:

        def fn(lin):
            u, v, ok = composite_map(pieces, 2, lin)
            return u, (n - 1) - v, ok  # strict (u, v) -> (col, row)

    else:

        def fn(lin):
            return composite_map(pieces, m, lin)

    alpha = 0.0 if m == 2 else alpha_extra_space(m, 2, m)
    return _Spec((steps,), fn, simplex_volume(n, m), "composite",
                 alpha=alpha, pieces=pieces)


@register_schedule(None, "bb")
def _build_md_bb(m: int, n: int) -> _Spec:
    def fn(lin):
        coords = []
        rem = lin
        for _ in range(m):
            coords.append(rem % n)
            rem = rem // n
        total = coords[0]
        for c in coords[1:]:
            total = total + c
        return tuple(coords) + (total < n,)

    return _Spec((n**m,), fn, simplex_volume(n, m), "bbmd",
                 alpha=math.factorial(m) - 1.0)


# ---------------------------------------------------------------------------
# deprecated 2D shim
# ---------------------------------------------------------------------------


class Schedule2D:
    """Deprecated thin shim over ``SimplexSchedule(2, n, kind)``.

    kind='hmap':  zero-waste (n/2, n+1) grid, paper Eq. 14-16 + the
                  diagonal rows; tile = (col, row) with col <= row.
    kind='rb':    zero-waste (n/2, n+1) grid, RB fold [37].
    kind='bb':    (n, n) bounding box + validity predicate (the baseline).

    Example:
        >>> import warnings
        >>> with warnings.catch_warnings():
        ...     warnings.simplefilter("ignore", DeprecationWarning)
        ...     s = Schedule2D(4, "hmap")
        >>> s.grid, s.steps, s.useful
        ((2, 5), 10, 10)
    """

    def __init__(self, n: int, kind: str = "hmap"):
        warnings.warn(
            "Schedule2D is deprecated; use SimplexSchedule(2, n, kind)",
            DeprecationWarning,
            stacklevel=2,
        )
        assert kind in ("hmap", "rb", "bb")
        self.n = n
        self.kind = kind
        self._s = SimplexSchedule(2, n, kind)

    @property
    def grid(self) -> Tuple[int, int]:
        """(width, height) of the delegated ``SimplexSchedule(2, ...)``."""
        return self._s.grid

    @property
    def steps(self) -> int:
        """Total grid steps of the delegated schedule."""
        return self._s.steps

    @property
    def useful(self) -> int:
        """Lower-triangle tiles to cover, ``tri(n)``."""
        return self._s.useful

    def map(self, wx, wy):
        """Delegate to ``SimplexSchedule.map``: (wx, wy) -> (x, y, valid)."""
        return self._s.map(wx, wy)

    def table(self) -> np.ndarray:
        """Delegate to ``SimplexSchedule.table()``."""
        return self._s.table()


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------


def schedule2d_table(n: int) -> np.ndarray:
    """Exact (tri(n), 2) int32 table of lower-triangle tiles, diagonal
    first, then row by row (vectorised; the same order as a row loop).

    Example:
        >>> schedule2d_table(3).tolist()
        [[0, 0], [1, 1], [2, 2], [0, 1], [0, 2], [1, 2]]
    """
    diag = np.arange(n, dtype=np.int64)
    rows = np.repeat(diag, diag)  # row y carries y off-diagonal tiles
    cols = np.arange(len(rows), dtype=np.int64) - np.repeat(diag * (diag - 1) // 2, diag)
    return np.stack(
        [np.concatenate([diag, cols]), np.concatenate([diag, rows])], 1
    ).astype(np.int32)


def schedule3d_table(n: int) -> np.ndarray:
    """Exact (tet(n), 3) int32 table of T(n) tiles (x, y, z), x fastest.

    Example:
        >>> schedule3d_table(2).tolist()
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]
    """
    return np.ascontiguousarray(enumerate_simplex(n, 3)[:, ::-1]).astype(np.int32)


def folded_causal_pairs(n_tiles: int) -> np.ndarray:
    """Folded pairs (i, n-1-i): the equal-area causal partition.

    An odd tile count self-pairs the middle tile in the last row.

    Example:
        >>> folded_causal_pairs(5).tolist()
        [[0, 4], [1, 3], [2, 2]]
    """
    if n_tiles < 1:
        raise ValueError(f"n_tiles must be >= 1, got {n_tiles}")
    i = np.arange((n_tiles + 1) // 2, dtype=np.int32)
    return np.stack([i, n_tiles - 1 - i], 1)


def grid_steps(n: int, kind: str, m: int = 2) -> int:
    """Grid steps each schedule launches — the paper's 'parallel space'.

    Example:
        >>> grid_steps(16, "hmap"), grid_steps(16, "bb")
        (136, 256)
    """
    if m == 3 and kind == "paper":
        w, h, d = H.hmap3_paper_grid_shape(n)
        return w * h * d
    return SimplexSchedule(m, n, kind).steps
