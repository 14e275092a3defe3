"""Dense PyTorch oracles for the simplex kernels.

Each function is the semantic ground truth over the whole ``(n,)*m``
array, independent of any schedule: masks of the domain, ``+1``,
pairwise distances and Game-of-Life steps by shifting the array.  Like
the JAX package's oracles they zero everything off the domain (the
kernels instead keep their input there).
"""

from __future__ import annotations

import itertools

import torch

from ..core.schedule import SimplexSchedule

__all__ = [
    "tril_mask",
    "tetra_mask",
    "simplex_mask",
    "map_table_2d",
    "accum2d",
    "accum3d",
    "accum_md",
    "edm2d",
    "edm3d",
    "edm_md",
    "ca2d_step",
    "ca3d_step",
    "ca_md_step",
    "causal_attention",
]


def tril_mask(n: int, dtype=torch.bool, device=None) -> torch.Tensor:
    """Inclusive lower-triangle mask {col <= row} of an n x n grid.

    Example:
        >>> tril_mask(3, torch.int32).tolist()
        [[1, 0, 0], [1, 1, 0], [1, 1, 1]]
    """
    r = torch.arange(n, device=device)
    return (r[None, :] <= r[:, None]).to(dtype)


def tetra_mask(n: int, dtype=torch.bool, device=None) -> torch.Tensor:
    """T(n) = {x+y+z < n} mask of an n^3 grid, axes (z, y, x)."""
    return simplex_mask(3, n, dtype, device)


def simplex_mask(m: int, n: int, dtype=torch.bool, device=None) -> torch.Tensor:
    """The m-simplex domain mask in array-axis order.

    m=2 is the inclusive lower triangle {col <= row}; m >= 3 is the
    strict simplex {sum(coords) < n}.

    Example:
        >>> int(simplex_mask(3, 4).sum())  # tet(4)
        20
    """
    if m == 2:
        return tril_mask(n, dtype, device)
    r = torch.arange(n, device=device)
    s = torch.zeros((n,) * m, dtype=torch.int64, device=device)
    for ax in range(m):
        shape = [1] * m
        shape[ax] = n
        s = s + r.reshape(shape)
    return (s < n).to(dtype)


def map_table_2d(n_blocks: int, kind: str) -> torch.Tensor:
    """Oracle for the MAP test: the schedule's host walk table."""
    return torch.from_numpy(SimplexSchedule(2, n_blocks, kind).table())


def accum_md(x: torch.Tensor) -> torch.Tensor:
    """ACCUM oracle (m = x.ndim): +1 on the simplex, 0 off it."""
    m, n = x.ndim, x.shape[0]
    return (x + 1) * simplex_mask(m, n, x.dtype, x.device)


def accum2d(x: torch.Tensor) -> torch.Tensor:
    """ACCUM oracle at m=2: +1 on the inclusive lower triangle, 0 above."""
    return accum_md(x)


def accum3d(x: torch.Tensor) -> torch.Tensor:
    """ACCUM oracle at m=3: +1 on T(n), 0 off it."""
    return accum_md(x)


def edm_md(p: torch.Tensor, m: int) -> torch.Tensor:
    """EDM oracle: ``out[c] = sum_{a<b} ||p[c_a] - p[c_b]||``, 0 off the
    domain; float32 arithmetic, output in ``p.dtype``.

    Example:
        >>> p = torch.tensor([[0.0], [3.0]])
        >>> edm_md(p, 2).tolist()
        [[0.0, 0.0], [3.0, 0.0]]
    """
    n = p.shape[0]
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    d = torch.sqrt(d2.to(torch.float32))
    out = torch.zeros((n,) * m, dtype=torch.float32, device=p.device)
    for i in range(m):
        for j in range(i + 1, m):
            shape = [1] * m
            shape[i] = n
            shape[j] = n
            out = out + d.reshape(shape)
    msk = simplex_mask(m, n, torch.float32, p.device)
    return (out * msk).to(p.dtype)


def edm2d(p: torch.Tensor) -> torch.Tensor:
    """EDM oracle at m=2: out[i, j] = ||p_i - p_j|| for j <= i, else 0."""
    return edm_md(p, 2)


def edm3d(p: torch.Tensor) -> torch.Tensor:
    """EDM oracle at m=3: per-cell triangle perimeter on T(n)."""
    return edm_md(p, 3)


def _life(s: torch.Tensor, neigh: torch.Tensor, dtype) -> torch.Tensor:
    born = (s == 0) & (neigh == 3)
    survive = (s == 1) & ((neigh == 2) | (neigh == 3))
    return (born | survive).to(dtype)


def ca2d_step(state: torch.Tensor) -> torch.Tensor:
    """Game-of-Life step on the inclusive lower triangle with periodic
    wrap on the underlying square; cells off the triangle are dead."""
    n = state.shape[0]
    msk = tril_mask(n, state.dtype, state.device)
    s = state * msk
    neigh = torch.zeros_like(s)
    for dy, dx in itertools.product((-1, 0, 1), repeat=2):
        if dy == 0 and dx == 0:
            continue
        neigh = neigh + torch.roll(s, (dy, dx), dims=(0, 1))
    return _life(s, neigh, state.dtype) * msk


def ca_md_step(state: torch.Tensor) -> torch.Tensor:
    """General-m CA oracle (m = state.ndim >= 3): one (3^m - 1)-neighbour
    B3/S23 step on the simplex with free boundaries."""
    m, n = state.ndim, state.shape[0]
    if m < 3:
        raise ValueError("the 2-simplex CA is periodic — use ca2d_step")
    msk = simplex_mask(m, n, state.dtype, state.device)
    s = state * msk
    pad = torch.nn.functional.pad(s, (1, 1) * m)
    neigh = torch.zeros_like(s)
    for shift in itertools.product((-1, 0, 1), repeat=m):
        if all(d == 0 for d in shift):
            continue
        sl = tuple(slice(1 + d, 1 + d + n) for d in shift)
        neigh = neigh + pad[sl]
    return _life(s, neigh, state.dtype) * msk


def ca3d_step(state: torch.Tensor) -> torch.Tensor:
    """26-neighbour Game-of-Life step on T(n), free boundaries."""
    return ca_md_step(state)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float | None = None) -> torch.Tensor:
    """Reference causal attention (GQA aware).

    q: (B, Hq, S, D), k/v: (B, Hkv, S, D) with Hq % Hkv == 0.  Softmax in
    float32 over the dense (S, S) scores; output in ``q.dtype``.

    Example:
        >>> q = torch.ones(1, 2, 3, 4)
        >>> causal_attention(q, q[:, :1], q[:, :1]).shape
        torch.Size([1, 2, 3, 4])
    """
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk).to(torch.float32) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(vv.dtype), vv).to(q.dtype)
