"""General-n simplex domains as power-of-two pieces (§4.2).

The paper's map H needs a power-of-two n (§4.1) and serves general n by
decomposing the domain into exactly-schedulable pieces (§4.2).  Two
generations of that idea live here:

* **2-simplex trapezoids** (the paper's concurrent-kernel scheme):
  power-of-two triangles along the diagonal, each completed by the box
  to its left; ``decompose`` / ``trapezoid_map`` keep one ``(w, h)``
  grid per piece.  Host-side only: no kernel launches over them.
* **General-m composite pieces**: for any dimension m >= 2 and any side
  n the strict simplex splits as

    T^m(n) = T^m(p)  ⊎  ⊎_{k=0}^{m-1}  T^k(p) ⋉ T^{m-k}(q),
    p = pow2_floor(n),  q = n - p

where ``T^k(p) ⋉ T^{m-k}(q)`` is a sheared prism: a power-of-two
k-simplex prefix over the top k coordinates whose sum ``s`` shears the
remainder's top coordinate by ``p - s``.  Flattening the recursion gives
*atomic pieces* — chains of power-of-two factors — concatenated into one
linear grid (DESIGN.md §4.2).  O(log^m n) pieces, O(pieces) host work.

The piece maps are dual-backend (numpy or torch).  ``pack_pieces`` lays
the pieces out as the flat int32 array the CUDA map decodes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import numpy as np

from .hmap import _as_index, _xp, hmap2_full, hmap_factor, hmap_factor_grid_size

__all__ = [
    "Trapezoid",
    "decompose",
    "trapezoid_map",
    "total_grid_cells",
    "SimplexPiece",
    "decompose_simplex",
    "composite_grid_size",
    "composite_map",
    "piece_map",
    "pack_pieces",
]


@dataclass(frozen=True)
class Trapezoid:
    """One piece of the 2-simplex concurrent-trapezoid decomposition.

    A trapezoid covers data rows ``[offset, offset + side)`` of the
    inclusive lower triangle: the power-of-two triangle of side ``side``
    on the diagonal plus the ``side x offset`` box completing its rows to
    the left.

    Attributes:
        offset: First data row covered; also the width of the box part.
        side: Triangle side length (a power of two).
        overshoot: Rows beyond n covered by a rounded-up final piece
            (``trapezoid_map`` flags them invalid).

    Example:
        >>> t = Trapezoid(offset=4, side=2, overshoot=0)
        >>> t.grid_shape, t.grid_cells, t.data_tiles
        ((1, 11), 11, 11)
    """

    offset: int
    side: int
    overshoot: int

    @property
    def grid_shape(self) -> Tuple[int, int]:
        """(width, height) of this piece's grid: ``(s/2, (s+1) + 2*o)``,
        or ``(1, o+1)`` for a side-1 piece (one data row)."""
        if self.side == 1:
            return 1, self.offset + 1
        return self.side // 2, (self.side + 1) + 2 * self.offset

    @property
    def grid_cells(self) -> int:
        """Total grid cells launched for this piece (width * height)."""
        w, h = self.grid_shape
        return w * h

    @property
    def data_tiles(self) -> int:
        """Tiles inside the simplex (overshoot rows excluded)."""
        s, o = self.side, self.offset
        full = o * s + s * (s + 1) // 2
        for y in range(s - self.overshoot, s):
            full -= o + y + 1
        return full


def decompose(n: int, threshold: int = 4) -> List[Trapezoid]:
    """Split the side-n lower triangle into concurrent trapezoids.

    Paper §4.2 option 3: approach n from below with power-of-two
    triangles; once the remainder drops under ``threshold`` it is
    rounded *up* to the next power of two (one final trapezoid whose
    excess rows are invalid).

    Args:
        n: Side of the triangle domain (rows), n >= 1.
        threshold: Remainder below which the tail is rounded up.

    Returns:
        ``Trapezoid`` pieces covering rows ``[0, n)`` exactly.

    Example:
        >>> [(t.offset, t.side, t.overshoot) for t in decompose(7)]
        [(0, 4, 0), (4, 4, 1)]
    """
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    pieces: List[Trapezoid] = []
    offset, remaining = 0, n
    while remaining > 0:
        p = 1 << (remaining.bit_length() - 1)
        if remaining < threshold and p != remaining:
            p_up = 1 << remaining.bit_length()
            pieces.append(Trapezoid(offset, p_up, p_up - remaining))
            return pieces
        pieces.append(Trapezoid(offset, p, 0))
        offset += p
        remaining -= p
    return pieces


def trapezoid_map(t: Trapezoid, wx, wy) -> Tuple[Any, Any, Any]:
    """Map grid coordinates of one trapezoid to global data tiles.

    Grid rows ``[0, side]`` walk the power-of-two triangle through
    ``hmap2_full``; rows above fold the box, two grid rows per
    ``side/2``-wide strip, with the paper's Eq. 19 mask
    ``k = (h1 - wy) >> 31`` as a 0/1 selector.  Numpy or torch.

    Args:
        t: The piece (from ``decompose``).
        wx: Grid column index/array in ``[0, grid_shape[0])``.
        wy: Grid row index/array in ``[0, grid_shape[1])``.

    Returns:
        ``(x, y, valid)`` global tile coordinates; ``valid`` is false
        only on the overshoot rows of a rounded-up final piece.

    Example:
        >>> t = Trapezoid(offset=4, side=2, overshoot=0)
        >>> x, y, v = trapezoid_map(t, np.zeros(11, np.int64), np.arange(11))
        >>> sorted(zip(y.tolist(), x.tolist()))[:3]
        [(4, 0), (4, 1), (4, 2)]
    """
    s, o = t.side, t.offset
    xp = _xp(wx, wy)
    wx, wy = _as_index(wx), _as_index(wy)
    if s == 1:  # one data row: tile (wy, offset)
        return wy, o + xp.zeros_like(wy), xp.zeros_like(wx) == 0
    k = ((s - wy) >> 31) & 1  # 1 on the box rows above the triangle
    tx, ty = hmap2_full(wx, xp.clip(wy, 0, s), s)
    lin = (wy - (s + 1)) * (s // 2) + wx  # the box's linear cell
    width = max(o, 1)
    x = xp.where(k == 1, lin % width, o + tx)
    y_local = xp.where(k == 1, lin // width, ty)
    return x, o + y_local, y_local < (s - t.overshoot)


def total_grid_cells(n: int, threshold: int = 4) -> int:
    """Grid cells of every trapezoid of ``decompose(n, threshold)``.

    Example:
        >>> total_grid_cells(6)  # tri(6) = 21: no waste at even n
        21
    """
    return sum(t.grid_cells for t in decompose(n, threshold))


@dataclass(frozen=True)
class SimplexPiece:
    """One atomic piece of the general-m composite decomposition.

    A piece is a chain of simplex *factors* ``(dim, side, delta)``
    occupying coordinate groups from the top coordinate ``x_{m-1}``
    downward.  ``delta`` is the static shear offset added to the
    factor's top coordinate; the dynamic shear ``side - sum(z)`` of each
    factor is applied to the next factor's top coordinate at decode time.

    Attributes:
        groups: Chain ``((dim, side, delta), ...)``; dims sum to m.

    Example:
        >>> piece = SimplexPiece(((1, 2, 0), (1, 1, 0)))
        >>> piece.grid_cells, piece.data_cells
        (2, 2)
    """

    groups: Tuple[Tuple[int, int, int], ...]

    @property
    def grid_cells(self) -> int:
        """Grid cells this piece launches: product of factor grid sizes."""
        g = 1
        for dim, side, _ in self.groups:
            g *= hmap_factor_grid_size(side, dim)
        return g

    @property
    def data_cells(self) -> int:
        """Simplex cells the piece covers: product of factor volumes."""
        v = 1
        for dim, side, _ in self.groups:
            v *= math.comb(side + dim - 1, dim)
        return v


def _is_pow2(s: int) -> bool:
    return s >= 1 and (s & (s - 1)) == 0


def decompose_simplex(m: int, n: int) -> List[SimplexPiece]:
    """Decompose the strict m-simplex T^m(n) into power-of-two pieces.

    Args:
        m: Simplex dimension, m >= 1.
        n: Side length, n >= 1 (any value, not just powers of two).

    Returns:
        List of ``SimplexPiece``; total ``data_cells`` equals
        ``simplex_volume(n, m)``.

    Example:
        >>> [p.groups for p in decompose_simplex(2, 3)]
        [((2, 2, 0),), ((2, 1, 2),), ((1, 2, 0), (1, 1, 0))]
    """
    if m < 1 or n < 1:
        raise ValueError(f"need m >= 1 and n >= 1, got m={m}, n={n}")

    def _rec(d: int, s: int, delta: int) -> List[Tuple[Tuple[int, int, int], ...]]:
        if d == 1 or _is_pow2(s):
            return [((d, s, delta),)]
        p = 1 << (s.bit_length() - 1)
        q = s - p
        chains = [((d, p, delta),)]  # core
        chains += _rec(d, q, delta + p)  # P_0: static shear by p
        for k in range(1, d):
            for sub in _rec(d - k, q, 0):
                chains.append(((k, p, delta),) + sub)  # P_k prefix
        return chains

    return [SimplexPiece(c) for c in _rec(m, n, 0)]


def composite_grid_size(m: int, n: int) -> int:
    """Total linear-grid steps of the composite schedule for T^m(n).

    Example:
        >>> composite_grid_size(2, 100)  # m=2 composite is zero-waste
        5050
    """
    return sum(p.grid_cells for p in decompose_simplex(m, n))


def _decode_piece(piece: SimplexPiece, m: int, local, xp):
    """Decode one piece's local linear index to global strict coords."""
    sizes = [hmap_factor_grid_size(s, d) for d, s, _ in piece.groups]
    coords: List[Any] = [None] * m
    valid = None
    dyn = xp.zeros_like(local)
    hi = m - 1
    rem = local
    for g, (dim, side, delta) in enumerate(piece.groups):
        stride = math.prod(sizes[g + 1:])
        idx_g = rem // stride
        rem = rem - idx_g * stride
        out = hmap_factor(idx_g, side, dim)
        cs, vg = out[:-1], out[-1]
        valid = vg if valid is None else (valid & vg)
        sumz = cs[0]
        for c in cs[1:]:
            sumz = sumz + c
        shift = dyn + delta
        # factor slot dim-1 is the group's top coordinate: it takes the
        # shear; lower slots map to the next coordinate indices down.
        for j in range(dim):
            coords[hi - (dim - 1) + j] = cs[j] + (shift if j == dim - 1 else 0)
        dyn = side - sumz
        hi -= dim
    return coords, valid


def piece_map(piece: SimplexPiece, m: int, lin):
    """Decode ONE piece's local grid index (one launch per piece).

    Args:
        piece: One piece from ``decompose_simplex(m, n)``.
        m: Simplex dimension.
        lin: Local linear index/array in ``[0, piece.grid_cells)``.

    Returns:
        ``(x_0, ..., x_{m-1}, valid)``; invalid steps pinned to the origin.

    Example:
        >>> ps = decompose_simplex(2, 3)
        >>> xs, ys, v = piece_map(ps[0], 2, np.arange(ps[0].grid_cells))
        >>> sorted(zip(xs[v].tolist(), ys[v].tolist()))
        [(0, 0), (0, 1), (1, 0)]
    """
    xp = _xp(lin)
    lin = _as_index(lin)
    cs, v = _decode_piece(piece, m, lin, xp)
    cs = [xp.where(v, c, 0) for c in cs]
    return tuple(cs) + (v,)


def composite_map(pieces: Sequence[SimplexPiece], m: int, lin):
    """Map a composite schedule's linear grid index to simplex coords.

    Pieces are concatenated in order; each index selects its piece by
    static prefix offsets and decodes that piece's factor chain.

    Args:
        pieces: Pieces from ``decompose_simplex(m, n)``.
        m: Simplex dimension.
        lin: Linear grid index/array in ``[0, composite_grid_size(m, n))``.

    Returns:
        ``(x_0, ..., x_{m-1}, valid)`` in math order (strict simplex
        ``sum(x) < n``); invalid steps report coordinates pinned to 0.

    Example:
        >>> ps = decompose_simplex(2, 3)
        >>> xs, ys, v = composite_map(ps, 2, np.arange(6))
        >>> sorted(zip(xs[v].tolist(), ys[v].tolist()))
        [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0)]
    """
    xp = _xp(lin)
    lin = _as_index(lin)
    out_coords = [xp.zeros_like(lin) for _ in range(m)]
    out_valid = xp.zeros_like(lin) != 0
    off = 0
    for piece in pieces:
        g = piece.grid_cells
        sel = (lin >= off) & (lin < off + g)
        local = xp.clip(lin - off, 0, g - 1)
        cs, v = _decode_piece(piece, m, local, xp)
        for j in range(m):
            out_coords[j] = xp.where(sel, cs[j], out_coords[j])
        out_valid = out_valid | (sel & v)
        off += g
    out_coords = [xp.where(out_valid, c, 0) for c in out_coords]
    return tuple(out_coords) + (out_valid,)


def pack_pieces(pieces: Sequence[SimplexPiece], m: int) -> np.ndarray:
    """The flat int32 layout of a piece list that the CUDA map decodes.

    ``[prefix_0 .. prefix_P]`` (each piece's first linear grid index,
    then the total), followed by one record of ``1 + 4*m`` int32s per
    piece: its factor count, then ``(dim, side, delta, grid_cells)`` per
    factor, zero-padded to m factors.

    Args:
        pieces: Pieces from ``decompose_simplex(m, n)`` (or one of them).
        m: Simplex dimension.

    Returns:
        1-D int32 array of length ``P + 1 + P * (1 + 4*m)``.

    Example:
        >>> pack_pieces(decompose_simplex(2, 2), 2).tolist()
        [0, 3, 1, 2, 2, 0, 3, 0, 0, 0, 0]
    """
    prefix = [0]
    for p in pieces:
        prefix.append(prefix[-1] + p.grid_cells)
    if prefix[-1] >= 2**31:
        raise ValueError(f"composite grid of {prefix[-1]} steps exceeds int32")
    recs = []
    for p in pieces:
        if len(p.groups) > m or sum(g[0] for g in p.groups) != m:
            raise ValueError(f"piece {p.groups} is not a chain of dimension {m}")
        rec = [len(p.groups)]
        for dim, side, delta in p.groups:
            rec += [dim, side, delta, hmap_factor_grid_size(side, dim)]
        rec += [0] * (1 + 4 * m - len(rec))
        recs += rec
    return np.asarray(prefix + recs, dtype=np.int32)
