"""General-n simplex domains as chains of power-of-two pieces (§4.2).

The paper's map H needs a power-of-two n (§4.1) and serves general n by
decomposing the domain into exactly-schedulable pieces (§4.2).  For any
dimension m >= 2 and any side n the strict simplex splits as

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

from .hmap import _as_index, _xp, hmap_factor, hmap_factor_grid_size

__all__ = [
    "SimplexPiece",
    "decompose_simplex",
    "composite_grid_size",
    "composite_map",
    "piece_map",
    "pack_pieces",
]


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
