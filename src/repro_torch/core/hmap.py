"""The paper's block-space map  H : Z^m -> Z^m  (§4), numpy or torch.

Everything here is integer and bit arithmetic only (Definition 4.1): no
roots and no float transcendentals.  Every map is *dual-backend*: it
takes numpy arrays or Python ints (host-side grid construction, tests)
or ``torch.Tensor``s (the plain PyTorch versions of the kernels walk a
schedule with these on the card).  The CUDA kernels evaluate the same
functions per block in ``kernels/csrc/simplex_maps.cuh``.

2-simplex (Thm 4.3)
-------------------
Grid ``(n/2, n-1)``, block ``w = (wx, wy)``:

    b = 2^floor(log2 wy),  q = wx // b,  H(w) = (wx + q*b, wy + 2*q*b)

is a bijection onto the strict lower triangle ``{x < y <= n-1}`` (n a
power of two).  ``hmap2_full`` adds rows 0 and n, which carry the two
halves of the diagonal: grid ``(n/2, n+1)`` onto ``{x <= y <= n-1}``
with exactly ``n(n+1)/2`` blocks.

General m (§6, constructive)
----------------------------
``hmap_m_recursive`` is the orthant recursion (r = 1/2, beta = m):

    T^m(n) = ([0, n/2)^m ∩ T^m(n))  ⊎  ⊎_{i=1..m} (T^m(n/2) + n/2·e_i)

flattened into K = log2(n) levels of cubes; ``recursive_levels`` gives
the level table that the host ships to the device map.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = [
    "pow2_floor",
    "floor_log2",
    "hmap2",
    "hmap2_full",
    "hmap2_inverse",
    "hmap2_grid_shape",
    "hmap2_full_grid_shape",
    "hmap3_paper",
    "hmap3_paper_grid_shape",
    "octant_levels",
    "recursive_levels",
    "hmap3_octant",
    "hmap3_octant_grid_size",
    "hmap_m_recursive",
    "hmap_m_grid_size",
    "hmap_factor",
    "hmap_factor_grid_size",
]


def _is_torch(*xs: Any) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


# The handful of numpy functions the maps use, spelled for torch tensors.
_TORCH = SimpleNamespace(
    where=torch.where,
    zeros_like=torch.zeros_like,
    clip=torch.clamp,
)


def _xp(*xs: Any):
    """The array namespace of the arguments: the torch shim or numpy."""
    return _TORCH if _is_torch(*xs) else np


def _as_index(x):
    """An int64 array or tensor of ``x`` (tensors keep their device)."""
    if _is_torch(x):
        return x.to(torch.int64)
    return np.asarray(x, dtype=np.int64)


def pow2_floor(y):
    """Largest power of two <= y  (y >= 1).  Bit-smear: Eq. 14 without logs.

    Works identically for numpy ints/arrays and torch integer tensors.
    The CUDA map uses ``1 << (31 - __clz(y))`` (Eq. 17/18) instead.

    Example:
        >>> pow2_floor(np.arange(1, 9)).tolist()
        [1, 2, 2, 4, 4, 4, 4, 8]
    """
    y = y | (y >> 1)
    y = y | (y >> 2)
    y = y | (y >> 4)
    y = y | (y >> 8)
    y = y | (y >> 16)
    return y - (y >> 1)


def floor_log2(y):
    """floor(log2(y)) for y >= 1: bit length minus one.

    Example:
        >>> floor_log2(1), floor_log2(8), floor_log2(np.array([3, 4])).tolist()
        (0, 3, [1, 2])
    """
    if _is_torch(y):
        y64 = y.to(torch.int64)
        shifts = torch.arange(63, device=y.device)
        return ((y64.unsqueeze(-1) >> shifts) > 0).sum(-1) - 1
    y_arr = np.asarray(y)
    if y_arr.ndim == 0:
        return int(y_arr).bit_length() - 1
    out = np.frompyfunc(lambda v: int(v).bit_length() - 1, 1, 1)(y_arr)
    return out.astype(np.int64)


def hmap2(wx, wy) -> Tuple[Any, Any]:
    """Eq. 14-16: super-orthotope block (wx, wy) -> strict lower triangle.

    Domain: wx in [0, n/2), wy in [1, n-1], n a power of two.
    Image:  {(x, y) : 0 <= x < y <= n-1}, bijective.
    """
    b = pow2_floor(wy)
    q = wx // b
    return wx + q * b, wy + 2 * q * b


def hmap2_full(wx, wy, n: int) -> Tuple[Any, Any]:
    """Zero-waste inclusive-diagonal map: grid (n/2, n+1) -> {x <= y <= n-1}.

    Row 0:   (wx, wx)                 — first half of the diagonal
    Row n:   (n/2 + wx, n/2 + wx)     — second half of the diagonal
    Rows 1..n-1: Eq. 16 strict map.

    Example:
        >>> x, y = hmap2_full(np.array([0, 1]), np.array([0, 4]), 4)
        >>> x.tolist(), y.tolist()
        ([0, 3], [0, 3])
    """
    xp = _xp(wx, wy)
    if xp is np:
        wx, wy = np.asarray(wx), np.asarray(wy)
    wy_safe = xp.where((wy >= 1) & (wy <= n - 1), wy, 1)
    x_s, y_s = hmap2(wx, wy_safe)
    diag0 = wy == 0
    diagn = wy == n
    x = xp.where(diag0, wx, xp.where(diagn, n // 2 + wx, x_s))
    y = xp.where(diag0, wx, xp.where(diagn, n // 2 + wx, y_s))
    return x, y


def hmap2_inverse(x, y) -> Tuple[Any, Any]:
    """Inverse of ``hmap2`` (strict lower triangle -> super-orthotope).

    x and y share all bits above position log2(b) and differ exactly at
    that bit, so ``b = pow2_floor(x XOR y)`` and ``q = x // (2b)``.
    """
    b = pow2_floor(x ^ y)
    q = x // (2 * b)
    return x - q * b, y - 2 * q * b


def hmap2_grid_shape(n: int) -> Tuple[int, int]:
    """(width, height) of the strict-map super-orthotope Pi^2_{n/2, n-1}."""
    return n // 2, n - 1


def hmap2_full_grid_shape(n: int) -> Tuple[int, int]:
    """(width, height) of the zero-waste inclusive-diagonal grid."""
    return n // 2, n + 1


# ---------------------------------------------------------------------------
# 3-simplex, literal Eq. 26 (kept for the calibration count)
# ---------------------------------------------------------------------------


def hmap3_paper_grid_shape(n: int) -> Tuple[int, int, int]:
    """Pi^3_{n/2, n/2, 3(n-1)/4} (Thm 4.6)."""
    return n // 2, n // 2, 3 * (n - 1) // 4 + 1


def hmap3_paper(wx, wy, wz, n: int):
    """Eq. 26, literal reading.  Returns (x, y, z, valid).

    The printed equation under-determines the packing geometry; this
    literal form covers only part of T(n), and callers predicate on
    ``valid``.
    """
    xp = _xp(wx, wy, wz)
    if xp is np:
        wx, wy, wz = np.asarray(wx), np.asarray(wy), np.asarray(wz)
    half = n // 2
    wy_safe = xp.where(wy >= 1, wy, 1)
    b = pow2_floor(wy_safe)
    q = wx // b
    c1 = wz < half
    x1, y1, z1 = wx, wy + half, wz
    x2, y2, z2 = wx + q * b, wy + 2 * q * b, wz - half
    in2 = (x2 + y2 + z2) < n
    x3 = b * (1 + 2 * q) - wx
    y3 = 2 * b * (1 + q) - wy
    z3 = 2 * b - wz + half
    x = xp.where(c1, x1, xp.where(in2, x2, x3))
    y = xp.where(c1, y1, xp.where(in2, y2, y3))
    z = xp.where(c1, z1, xp.where(in2, z2, z3))
    valid = (x >= 0) & (y >= 0) & (z >= 0) & ((x + y + z) < n)
    return x, y, z, valid


# ---------------------------------------------------------------------------
# Exact m-simplex map: orthant recursion (r = 1/2, beta = m)
#
# Level k = 1..K-1 has m^(k-1) cubes of side n/2^k (cells with local sum
# >= 2*side are the dead far-corner hole); the terminal level K has
# m^(K-1) cubes of side 2 covering their T(2) sub-simplex entirely.
# ---------------------------------------------------------------------------


def octant_levels(n: int) -> int:
    """Number of levels K = log2(n); the terminal level has side-2 cubes."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"recursive map requires power-of-two n, got {n}")
    return n.bit_length() - 1


def recursive_levels(n: int, m: int) -> Tuple[List[int], List[int]]:
    """Level table of the orthant recursion: ``(prefix, sides)``.

    ``sides[k]`` is the cube side of level k (k = 0..K-1, the last is the
    terminal side-2 level) and ``prefix[k]`` the first linear grid index
    of level k; ``prefix[K]`` is the grid size.  This is what the host
    packs into the device map's descriptor.

    Example:
        >>> recursive_levels(8, 3)
        ([0, 64, 88, 160], [4, 2, 2])
    """
    K = octant_levels(n)
    sides = [n >> k for k in range(1, K)] + [2]
    prefix = [0]
    for k, side in enumerate(sides):
        prefix.append(prefix[-1] + m**k * side**m)
    return prefix, sides


def _check_r_beta(m: int, inv_r: int, beta) -> int:
    beta = m if beta is None else beta
    if inv_r != 2 or beta != m:
        raise NotImplementedError(
            f"no explicit construction for (1/r, beta) = ({inv_r}, {beta}) at "
            f"m={m}; only the orthant partition (2, {m}) has a known "
            "bijective map (DESIGN.md §4)"
        )
    return beta


def hmap_m_grid_size(n: int, m: int, inv_r: int = 2, beta=None) -> int:
    """Total grid cells of the recursive m-simplex map.

    Example:
        >>> hmap_m_grid_size(8, 3)
        160
    """
    _check_r_beta(m, inv_r, beta)
    return recursive_levels(n, m)[0][-1]


def hmap_m_recursive(idx, n: int, m: int, inv_r: int = 2, beta=None):
    """Exact linear-grid m-simplex map: idx in [0, grid_size) ->
    (x_0, ..., x_{m-1}, valid).

    Bijective onto T(n) = {sum(x) < n} over the valid cells; dead cells
    (valid=0) are the far-corner holes of each level cube.  Dual-backend
    (numpy ints/arrays or torch tensors, computed in int64).

    Example:
        >>> x0, x1, x2, v = hmap_m_recursive(np.arange(160), 8, 3)
        >>> int(v.sum())  # tet(8)
        120
    """
    _check_r_beta(m, inv_r, beta)
    xp = _xp(idx)
    idx = _as_index(idx)
    K = octant_levels(n)
    prefix, sides = recursive_levels(n, m)

    level = xp.zeros_like(idx)
    for k in range(1, K):
        level = xp.where(idx >= prefix[k], level + 1, level)
    base = xp.zeros_like(idx)
    s = xp.zeros_like(idx)
    bound = xp.zeros_like(idx)
    for lvl, side in enumerate(sides):
        here = level == lvl
        base = xp.where(here, prefix[lvl], base)
        s = xp.where(here, side, s)
        bound = xp.where(here, 2 if lvl == K - 1 else 2 * side, bound)
    rem = idx - base
    c = rem // (s**m)
    p = rem - c * (s**m)
    # local coordinates inside the level cube: x_0 fastest
    loc = []
    q = p
    for _ in range(m):
        loc.append(q % s)
        q = q // s
    # offsets from the base-m path digits of c: digit j (j < level)
    # chooses the displacement axis for a step of n >> (j+1).
    offs = [xp.zeros_like(idx) for _ in range(m)]
    cc = c
    for j in range(K - 1):
        active = j < level
        d = cc % m
        step = n >> (j + 1)
        for ax in range(m):
            offs[ax] = xp.where(active & (d == ax), offs[ax] + step, offs[ax])
        cc = xp.where(active, cc // m, cc)
    coords = tuple(offs[j] + loc[j] for j in range(m))
    lsum = loc[0]
    for lj in loc[1:]:
        lsum = lsum + lj
    valid = lsum < bound
    return coords + (valid,)


def hmap_factor_grid_size(side: int, dim: int) -> int:
    """Grid cells ``hmap_factor`` launches for a (dim, side) simplex factor.

    Zero waste for dim <= 2; the orthant recursion's grid for dim >= 3.

    Example:
        >>> hmap_factor_grid_size(4, 2), hmap_factor_grid_size(8, 3)
        (10, 160)
    """
    if side == 1:
        return 1
    if dim == 1:
        return side
    if dim == 2:
        return (side // 2) * (side + 1)
    return hmap_m_grid_size(side, dim)


def _ones(x):
    if _is_torch(x):
        return torch.ones_like(x, dtype=torch.bool)
    return np.ones_like(np.asarray(x), dtype=bool)


def hmap_factor(idx, side: int, dim: int):
    """Linear idx -> one T^dim(side) factor of a composite piece.

    * ``side == 1`` — the point factor {0}^dim (grid 1).
    * ``dim == 1``  — interval [0, side), identity, any side.
    * ``dim == 2``  — strict-sum 2-simplex {u + v < side} through
      ``hmap2_full``, flipped by v = side-1-row.
    * ``dim >= 3``  — ``hmap_m_recursive`` (side a power of two).

    Returns ``(c_0, ..., c_{dim-1}, valid)``.
    """
    idx = _as_index(idx)
    if side == 1:
        z = idx * 0
        return (z,) * dim + (_ones(z),)
    if dim == 1:
        return idx, _ones(idx)
    if dim == 2:
        w = side // 2
        wy = idx // w
        wx = idx - wy * w
        col, row = hmap2_full(wx, wy, side)
        return col, (side - 1) - row, _ones(col)
    return hmap_m_recursive(idx, side, dim)


def hmap3_octant_grid_size(n: int) -> int:
    """Total grid cells of the m=3 (octant) instance (~n^3/5)."""
    return hmap_m_grid_size(n, 3)


def hmap3_octant(idx, n: int):
    """The m=3 instance of ``hmap_m_recursive`` -> (x, y, z, valid)."""
    return hmap_m_recursive(idx, n, 3)
