"""The paper's comparison maps (§3, §5, Fig. 9), numpy or torch.

* BB  — bounding box, f(x) = x with a discard predicate (Eq. 2).
* RB  — rectangular box [37] (Jung & O'Leary): fold the lower triangle
        into an (n/2) x (n+1) rectangle.
* LAMBDA — the enumeration map lambda(omega) [22, 24]: closed-form
        inversion of the simplicial number with a square (2-simplex) or
        cube (3-simplex) root.  These are host-only (numpy): FP precision
        limits their range exactly as the paper describes (§3).

BB and RB are dual-backend like ``hmap``; the CUDA kernels evaluate the
same functions in ``kernels/csrc/simplex_maps.cuh``.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np

from .hmap import _xp

__all__ = [
    "bb_map2",
    "bb_valid2",
    "bb_map3",
    "bb_valid3",
    "rb_map2",
    "rb_grid_shape",
    "lambda_map2",
    "lambda_map2_raw",
    "lambda_map3",
    "lambda_fp32_exact_range_2d",
    "tri_total",
]


# --------------------------------------------------------------------------
# Bounding box
# --------------------------------------------------------------------------


def bb_map2(wx, wy) -> Tuple[Any, Any]:
    """Identity map (Eq. 2); used with ``bb_valid2`` as run-time filter."""
    return wx, wy


def bb_valid2(x, y):
    """Inclusive lower-triangle predicate {x <= y} discarding ~n^2/2 blocks."""
    return x <= y


def bb_map3(wx, wy, wz) -> Tuple[Any, Any, Any]:
    """Identity bounding-box map for the 3-simplex (pair with bb_valid3)."""
    return wx, wy, wz


def bb_valid3(x, y, z, n: int):
    """T(n) predicate; discards ~5/6 of the n^3 bounding box."""
    return (x + y + z) < n


# --------------------------------------------------------------------------
# Rectangular box (RB) [37]
# --------------------------------------------------------------------------


def rb_grid_shape(n: int) -> Tuple[int, int]:
    """Grid (width, height) covering the inclusive lower triangle of n x n.

    n even: (n/2, n+1) — the same zero-waste volume as ``hmap2_full``.
    """
    if n % 2:
        raise ValueError(f"the RB fold needs an even block count, got {n}")
    return n // 2, n + 1


def rb_map2(wx, wy, n: int) -> Tuple[Any, Any]:
    """RB fold over grid (n/2, n+1), wy in [0, n]:

        wy >  wx:  (x, y) = (wx, wy - 1)                [direct left half]
        wy <= wx:  (x, y) = (n/2 + wy, n/2 + wx)        [folded right half]

    Bijective onto {x <= y <= n-1}.

    Example:
        >>> x, y = rb_map2(np.array([0, 1]), np.array([0, 3]), 4)
        >>> x.tolist(), y.tolist()
        ([2, 1], [2, 2])
    """
    xp = _xp(wx, wy)
    fold = wy <= wx
    x = xp.where(fold, n // 2 + wy, wx)
    y = xp.where(fold, n // 2 + wx, wy - 1)
    return x, y


# --------------------------------------------------------------------------
# Lambda enumeration map [22, 24] (host-only)
# --------------------------------------------------------------------------


def lambda_map2(w, dtype=np.float32) -> Tuple[Any, Any]:
    """lambda(w): Z -> Z^2 via the triangular-number inversion.

    Element w (0-based) of the inclusive lower triangle maps to
        y = floor( (sqrt(8w + 1) - 1) / 2 ),   x = w - y(y+1)/2,
    with the square root in ``dtype`` and one integer correction step.

    Example:
        >>> x, y = lambda_map2(np.arange(6))
        >>> list(zip(x.tolist(), y.tolist()))
        [(0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2)]
    """
    w = np.asarray(w)
    wf = w.astype(dtype)
    y = np.floor((np.sqrt(dtype(8.0) * wf + dtype(1.0)) - dtype(1.0)) / dtype(2.0))
    y = y.astype(np.int64)
    tri_y = y * (y + 1) // 2
    y = np.where(tri_y > w, y - 1, y)
    tri_y = y * (y + 1) // 2
    y = np.where(w - tri_y > y, y + 1, y)
    tri_y = y * (y + 1) // 2
    return w - tri_y, y


def lambda_map2_raw(w, dtype=np.float32) -> Tuple[Any, Any]:
    """Uncorrected lambda map — exhibits the raw FP32 failure range."""
    w = np.asarray(w)
    wf = w.astype(dtype)
    y = np.floor((np.sqrt(dtype(8.0) * wf + dtype(1.0)) - dtype(1.0)) / dtype(2.0))
    y = y.astype(np.int64)
    return w - y * (y + 1) // 2, y


def tri_total(n: int) -> int:
    """Triangular number n(n+1)/2 — the lambda maps' linear-domain size."""
    return n * (n + 1) // 2


def lambda_fp32_exact_range_2d() -> int:
    """Largest n (in steps of 4096) for which the uncorrected FP32
    lambda map is exact — the paper's bounded-range claim."""
    n = 1
    step = 4096
    while True:
        w = np.arange(tri_total(n + step) - 10, tri_total(n + step), dtype=np.int64)
        x, y = lambda_map2_raw(w)
        if not np.all((x >= 0) & (x <= y)):
            return n
        n += step
        if n > (1 << 20):
            return n


def lambda_map3(w, dtype=np.float64) -> Tuple[Any, Any, Any]:
    """lambda_3(w): Z -> Z^3 via tetrahedral-number inversion (cube root),
    integer-corrected like ``lambda_map2`` and composed with the
    prefix-difference bijection onto the standard simplex.

    Example:
        >>> [tuple(int(c[i]) for c in lambda_map3(np.arange(4))) for i in range(4)]
        [(0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0)]
    """
    w = np.asarray(w)
    wf = w.astype(dtype)
    z = np.floor(np.cbrt(dtype(6.0) * wf + dtype(1.0)) - dtype(1.0)).astype(np.int64)
    tet_z = z * (z + 1) * (z + 2) // 6
    z = np.where(tet_z > w, z - 1, z)
    tet_z = z * (z + 1) * (z + 2) // 6
    z = np.where(w - tet_z >= (z + 1) * (z + 2) // 2, z + 1, z)
    tet_z = z * (z + 1) * (z + 2) // 6
    rem = w - tet_z
    x2, y2 = lambda_map2(rem, dtype=np.float32 if dtype == np.float32 else np.float64)
    return x2, y2 - x2, z - y2
