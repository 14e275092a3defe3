"""Public entry points of the port's simplex kernels.

Each resolves its schedule kind, then runs the engine body on the card
(``device=None``) or, with ``device="cpu"``, through the body's plain
PyTorch version.  The defaults follow the JAX package's ``kernels/ops.py``:
``kind='auto'`` asks the autotuner for the tensors' device, and
``split=None`` asks it whether to launch a composite walk one piece at a
time.  The fused executors of ``kernels/compiled.py`` are exported as
``simplex_accum*_compiled``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..autotune.tuner import choose_attn_impl
from . import engine, ref
from .compiled import accum2d_compiled, accum3d_compiled, accum_md_compiled
from .flash_attention import flash_attention
from .hmap_mxu import hmap2_coords_mxu
from .policy import resolve_device

__all__ = [
    "simplex_accum2d",
    "simplex_edm2d",
    "simplex_ca2d",
    "simplex_accum3d",
    "simplex_ca3d",
    "simplex_accum_md",
    "simplex_edm3d",
    "simplex_edm_md",
    "simplex_ca_md",
    "simplex_accum2d_compiled",
    "simplex_accum3d_compiled",
    "simplex_accum_md_compiled",
    "map_table",
    "hmap_coords_mxu",
    "causal_flash_attention",
]


def simplex_accum2d(x, rho: int = 8, kind: str = "auto", device=None) -> torch.Tensor:
    """+1 on the inclusive lower triangle (engine ACCUM body at m=2)."""
    return engine.accum(x, rho=rho, kind=kind, device=device)


def simplex_edm2d(p, rho: int = 8, kind: str = "auto", device=None) -> torch.Tensor:
    """||p_i - p_j|| on the lower triangle (engine EDM body at m=2)."""
    return engine.edm2d(p, rho=rho, kind=kind, device=device)


def simplex_ca2d(state, rho: int = 8, kind: str = "auto", device=None) -> torch.Tensor:
    """One periodic Game-of-Life step on the triangle (CA body at m=2)."""
    return engine.ca(state, rho=rho, kind=kind, device=device)


def simplex_accum3d(x, rho: int = 4, kind: str = "auto",
                    split: Optional[bool] = None, device=None) -> torch.Tensor:
    """+1 on the 3-simplex T(n) (engine ACCUM body at m=3)."""
    return engine.accum(x, rho=rho, kind=kind, split=split, device=device)


def simplex_ca3d(state, rho: int = 4, kind: str = "auto", device=None) -> torch.Tensor:
    """One free-boundary Game-of-Life step on T(n) (CA body at m=3)."""
    return engine.ca(state, rho=rho, kind=kind, device=device)


def simplex_accum_md(x, rho: int = 2, kind: str = "auto",
                     split: Optional[bool] = None, device=None) -> torch.Tensor:
    """General-m accumulate; m = x.ndim >= 3 (DESIGN.md §4)."""
    return engine.accum_md(x, rho=rho, kind=kind, split=split, device=device)


def simplex_edm3d(p, rho: int = 4, kind: str = "auto",
                  split: Optional[bool] = None, device=None) -> torch.Tensor:
    """Per-cell triangle perimeter on T(n) (engine EDM body at m=3)."""
    return engine.edm3d(p, rho=rho, kind=kind, split=split, device=device)


def simplex_edm_md(p, m: int, rho: Optional[int] = None, kind: str = "auto",
                   split: Optional[bool] = None, device=None) -> torch.Tensor:
    """General-m EDM: out[c] = sum of pairwise distances of the cell's
    m points (m >= 3 — use simplex_edm2d at m=2)."""
    return engine.edm_md(p, m, rho=rho, kind=kind, split=split, device=device)


def simplex_ca_md(state, rho: Optional[int] = None, kind: str = "auto",
                  device=None) -> torch.Tensor:
    """General-m CA: one (3^m - 1)-neighbour Game-of-Life step on T(n),
    free boundaries (m = state.ndim >= 3)."""
    return engine.ca_md(state, rho=rho, kind=kind, device=device)


# The fused executors (kernels/compiled.py): the whole schedule walk as
# torch gather/scatter on the input's device.
simplex_accum2d_compiled = accum2d_compiled
simplex_accum3d_compiled = accum3d_compiled
simplex_accum_md_compiled = accum_md_compiled


def map_table(nb: int, kind: str = "hmap", m: int = 2, device=None) -> torch.Tensor:
    """The MAP test's output: (steps, m+1) coordinate table.

    Example:
        >>> tuple(map_table(2, kind="hmap", device="cpu").shape)  # tri(2) steps
        (3, 3)
    """
    return engine.map_table(nb, m=m, kind=kind, device=device)


def hmap_coords_mxu(wxy, rho: int = 1, device=None) -> torch.Tensor:
    """Tensor-core H map: ``(T, 2)`` int32 grid coords ``(wx, wy)`` ->
    element origins ``(x, y)`` (``hmap_mxu.hmap2_coords_mxu``, paper §7.1).

    Example:
        >>> w = torch.ones((128, 2), dtype=torch.int32)
        >>> hmap_coords_mxu(w, rho=8, device="cpu")[0].tolist()
        [16, 24]
    """
    return hmap2_coords_mxu(wxy, rho=rho, device=device)


def causal_flash_attention(q, k, v, kind: str = "auto", block_q: int = 0,
                           block_kv: int = 0, device=None) -> torch.Tensor:
    """Causal GQA attention through the flash kernel.

    ``kind='auto'`` resolves schedule and tile through
    ``autotune.choose_attn_impl``; a shape no tile maps runs the dense
    ``ref.causal_attention``, the reference's structural route.
    ``kind='folded'``/``'bb'`` forces the schedule, with ``block_q`` /
    ``block_kv`` passed to the kernel (0 lets the tuner pick the tile).

    Example:
        >>> q = torch.randn(1, 2, 64, 16)
        >>> causal_flash_attention(q, q, q, device="cpu").shape
        torch.Size([1, 2, 64, 16])
    """
    device = resolve_device(device)
    q, k, v = (torch.as_tensor(x, device=device) for x in (q, k, v))
    if kind == "auto" or block_q <= 0:
        b, hq, s, d = q.shape
        dec = choose_attn_impl(s, hq, d, device, q.dtype)
        if kind == "auto":
            if dec.impl != "flash" or dec.block_q <= 0:
                return ref.causal_attention(q, k, v)
            kind = dec.kind
        if block_q <= 0:
            if dec.block_q <= 0:
                return ref.causal_attention(q, k, v)
            block_q = block_kv = dec.block_q
    return flash_attention(q, k, v, kind=kind, block_q=block_q,
                           block_kv=block_kv or block_q, device=device)
