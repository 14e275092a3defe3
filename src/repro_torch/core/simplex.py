"""Standard discrete m-simplex domains (paper §2).

The standard discrete m-simplex of side ``n`` is

    Delta_n^m = { x in Z_+^m : 0 <= x_i <= n  and  sum(x) <= n }        (Eq. 3)

This module provides the exact volume formulas (simplicial polytopic
numbers, Eq. 4/5/7/20), membership predicates, and small-n enumeration
utilities used by tests and by the table-driven schedulers.

Conventions used throughout the code base
-----------------------------------------
* ``T(n)``      — the *strict* simplex ``{x in Z_+^m : sum(x) < n}``; its
                  cardinality equals ``V(Delta_n^m)`` of the paper (Eq. 4),
                  i.e. ``C(n+m-1, m)``.
* ``tri(n)``    — triangular number n(n+1)/2  = |T^2(n)|.
* ``tet(n)``    — tetrahedral number n(n+1)(n+2)/6 = |T^3(n)|.
* lower-triangular block sets for causal attention use matrix convention
  ``{(col, row): col <= row}`` (inclusive diagonal) or ``col < row``
  (strict); helpers below convert.

The PyTorch port keeps its own copy of this host arithmetic (numpy and
Python integers only), so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

__all__ = [
    "simplex_volume",
    "tri",
    "tet",
    "in_simplex",
    "enumerate_simplex",
    "enumerate_lower_triangle",
    "bounding_box_volume",
    "bb_overhead",
]


def simplex_volume(n: int, m: int) -> int:
    """V(Delta_n^m) = C(n+m-1, m)  (Eq. 4) — number of points with sum < n.

    Equivalent to the ``n``-th m-dimensional simplicial polytopic number.
    """
    if n <= 0:
        return 0
    return math.comb(n + m - 1, m)


def tri(n: int) -> int:
    """Triangular numbers — V(Delta_n^2) = n(n+1)/2  (Eq. 7)."""
    return n * (n + 1) // 2


def tet(n: int) -> int:
    """Tetrahedral numbers — V(Delta_n^3) = n(n+1)(n+2)/6  (Eq. 20)."""
    return n * (n + 1) * (n + 2) // 6


def in_simplex(x, n: int) -> bool:
    """Membership in the strict simplex T(n) = {x >= 0, sum(x) < n}."""
    arr = np.asarray(x)
    return bool((arr >= 0).all() and arr.sum() < n)


@lru_cache(maxsize=64)
def enumerate_simplex(n: int, m: int) -> np.ndarray:
    """All points of T(n) in Z^m, lexicographic. O(V) memory — tests only."""
    if m == 1:
        return np.arange(n, dtype=np.int64)[:, None]
    pts = []
    for first in range(n):
        rest = enumerate_simplex(n - first, m - 1)
        block = np.concatenate(
            [np.full((len(rest), 1), first, dtype=np.int64), rest], axis=1
        )
        pts.append(block)
    return np.concatenate(pts, axis=0)


def enumerate_lower_triangle(n: int, strict: bool = False) -> np.ndarray:
    """(col, row) pairs of the lower triangle of an n x n grid.

    ``strict=False`` includes the diagonal: {(x, y): x <= y} — the causal
    attention tile set.  ``strict=True`` gives {(x, y): x < y} — the image
    of the paper's 2-simplex map (Thm 4.3).
    """
    cols, rows = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    mask = cols < rows if strict else cols <= rows
    return np.stack([cols[mask], rows[mask]], axis=1).astype(np.int64)


def bounding_box_volume(n: int, m: int) -> int:
    """Parallel space of the bounding-box approach: n^m threads/blocks."""
    return n**m


def bb_overhead(m: int) -> float:
    """lim_{n->inf} V(BB)/V(Delta) - 1 = m! - 1   (Eq. 6)."""
    return math.factorial(m) - 1.0
