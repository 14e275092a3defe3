"""General m-simplex self-similar sets (paper §6).

Implements the volume recurrence Eq. 27-29, the extra-space fraction
Eq. 30 (Lemma 6.1), and the (r, beta) parameter optimization of
Theorem 6.2: finding an efficient self-similar set S_n^m for Delta_n^m
is an optimization over integer 1/r and beta with constraints
beta > 1, 1/r > beta.

The paper's headline: with r = 1/2, beta = 2 the set is efficient only
for m = 2, 3 (extra space m!/(2^m - 2) - 1); choosing r = m^(-1/m) makes
the asymptotic parallel-space saving the full m!, trading a larger
minimum problem size n0(beta).

The PyTorch port keeps its own copy of this host arithmetic (numpy and
Python integers only), so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

__all__ = [
    "self_similar_volume",
    "alpha_extra_space",
    "alpha_r_half_beta_2",
    "potential_speedup",
    "optimize_r_beta",
    "n0_coverage",
    "best_r_beta",
    "RBeta",
]


def self_similar_volume(n: int, m: int, inv_r: int = 2, beta: int = 2) -> int:
    """V(S_n^m) by direct expansion of the recurrence (Eq. 27):

        V(S_n^m) = (rn)^m + beta * V(S_{rn}^m),   r = 1/inv_r

    evaluated exactly in integers for n a power of inv_r.
    """
    v = 0
    mult = 1
    while n >= inv_r:
        n_next = n // inv_r
        v += mult * (n_next**m)
        mult *= beta
        n = n_next
    return v


def alpha_extra_space(m: int, inv_r: int = 2, beta: int = 2) -> float:
    """lim_{n->inf} V(S)/V(Delta) - 1.

    From Eq. 29: V(S) -> n^m / (inv_r^m - beta)  (when inv_r^m > beta),
    and V(Delta) -> n^m / m!, so alpha = m!/(inv_r^m - beta) - 1 (Eq. 30
    generalized).  Returns inf when the geometric series diverges.
    """
    denom = inv_r**m - beta
    if denom <= 0:
        return math.inf
    return math.factorial(m) / denom - 1.0


def alpha_r_half_beta_2(m: int) -> float:
    """Eq. 30: alpha = m!/(2^m - 2) - 1 for the r=1/2, beta=2 scheme."""
    return alpha_extra_space(m, inv_r=2, beta=2)


def potential_speedup(m: int, inv_r: int = 2, beta: int = 2) -> float:
    """Parallel-space ratio BB/S — the paper's 'potential speedup' (<= m!)."""
    return math.factorial(m) / (1.0 + alpha_extra_space(m, inv_r, beta))


@dataclass(frozen=True)
class RBeta:
    """One feasible (1/r, beta) lattice point of the Thm 6.2 optimization."""

    inv_r: int
    beta: int
    alpha: float  # asymptotic extra space fraction
    n0: int  # first power of inv_r from which V(S) >= V(Delta)
    speedup: float  # BB / V(S) asymptotic


def n0_coverage(m: int, inv_r: int, beta: int, n_max: int = 1 << 22) -> int:
    """Smallest n = inv_r^k with V(S_n^m) >= V(Delta_n^m) (coverage can
    begin), or 0 if none below n_max.  The paper: n0 grows with m and
    shrinks as beta grows — the trade-off of Thm 6.2."""
    n = inv_r
    while n <= n_max:
        v_s = self_similar_volume(n, m, inv_r, beta)
        v_d = math.comb(n + m - 1, m)
        if v_s >= v_d:
            return n
        n *= inv_r
    return 0


def optimize_r_beta(
    m: int, max_inv_r: int = 64, max_beta: int = 64, n_max: int = 1 << 22
) -> List[RBeta]:
    """Thm 6.2: minimize |V(S) - V(Delta)| asymptotically over integer
    (1/r, beta) with beta > 1, 1/r^m > beta.  Returns candidates sorted by
    extra space then n0.  The paper's suggestion r = m^(-1/m) corresponds
    to inv_r^m ~= m... the closest integer lattice points dominate."""
    out: List[RBeta] = []
    for inv_r in range(2, max_inv_r + 1):
        for beta in range(2, max_beta + 1):
            if inv_r**m <= beta:
                continue  # diverging series
            a = alpha_extra_space(m, inv_r, beta)
            if a < 0:  # undercovers asymptotically -> cannot map all of Delta
                continue
            n0 = n0_coverage(m, inv_r, beta, n_max)
            if n0 == 0:
                continue
            out.append(
                RBeta(inv_r, beta, a, n0, potential_speedup(m, inv_r, beta))
            )
    out.sort(key=lambda rb: (rb.alpha, rb.n0))
    return out


def best_r_beta(m: int, constructible: bool = False) -> Tuple[int, int]:
    """Best (1/r, beta) for dimension m.

    ``constructible=False`` — the unconstrained Thm 6.2 optimum over the
    integer lattice (minimal asymptotic extra space, then minimal n0).
    These are *feasibility* optima: for m >= 4 the winners (e.g.
    (3, 57) at m=4, alpha=0) have no known explicit bijective map.

    ``constructible=True`` — restrict to parameters for which an explicit
    map is implemented: the orthant-partition family (2, m) realized by
    ``hmap.hmap_m_recursive`` (extra space m!/(2^m - m) - 1).  For m=2
    this coincides with the paper's optimum (2, 2) at zero waste; for
    m=3 it is the octant map (20%).  Closing the gap between the two is
    a ROADMAP open item.
    """
    if constructible:
        assert 2**m > m, "orthant family converges for all m >= 1"
        return 2, m
    cands = optimize_r_beta(m)
    if not cands:
        raise ValueError(f"no feasible (r, beta) for m={m}")
    return cands[0].inv_r, cands[0].beta
