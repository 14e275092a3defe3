"""Batched H-map coordinates on the tensor cores — paper §7.1 (Eq. 32).

The paper sketches computing many block coordinates per Tensor-Core MMA
by laying the map's constants in A, per-block inputs in B and
thread-local offsets in C: ``D = A x B + C``.  The H map (Eq. 16) is
affine in ``(wx, wy, qb)``::

    x = rho * (wx + qb),   y = rho * (wy + 2 qb)

with ``b = pow2_floor(max(wy, 1))`` and ``qb = (wx // b) * b``, so
``A = rho * [[1, 0, 1, 0], [0, 1, 2, 0]]`` and one column of B per block
give the blocks' element origins in rows 0 and 1 of D.  C, the offset of
thread (0, 0) inside its block, is zero.

Two versions of that function:

* ``HMAP_MXU.kernel`` — the CUDA kernel of ``csrc/hmap_mxu.cu`` for CUDA
  tensors: FP64 ``mma.sync.m8n8k4`` products, a warp per 128 blocks with
  the blocks as A's rows, so each block's ``(x, y)`` comes out whole in
  one lane; exact over int32 (TF32 would round coordinates above 2^11);
  it adds one to ``launches``;
* ``HMAP_MXU.plain`` — the same product ``A @ B`` in float64 tensor ops,
  also exact.  CPU tensors take it; on the card it is the kernel's
  reference and nothing else.

The JAX package computes the product in float32 and is exact only for
outputs below 2^24; this port is exact for every output that fits int32.
"""

from __future__ import annotations

import torch

from ..core.hmap import pow2_floor
from . import _build
from .policy import on_card, resolve_device

__all__ = ["hmap2_coords_mxu", "HMAP_MXU", "launch_counts"]

# Blocks per group: one MXU pass in the reference, 16 MMAs of 8 on the card.
GROUP = 128


def _check(wxy: torch.Tensor) -> int:
    """The entry's contract: ``(T, 2)`` int32 with ``T % 128 == 0``."""
    t = wxy.shape[0] if wxy.ndim else 0
    if tuple(wxy.shape) != (t, 2) or t % GROUP:
        raise ValueError(f"hmap_mxu: expected (T, 2) grid coordinates with T % {GROUP} "
                         f"== 0, got {tuple(wxy.shape)}")
    if wxy.dtype != torch.int32:
        raise ValueError(f"hmap_mxu: expected int32 grid coordinates, got {wxy.dtype}")
    return t


class HmapMxuKernel:
    """The §7.1 coordinate map: ``(T, 2)`` int32 grid coordinates
    ``(wx, wy)`` to ``(T, 2)`` int32 element origins ``(x, y)``.

    Attributes:
        launches: Launches of the CUDA kernel so far, never of the plain
            version.
    """

    name = "hmap_mxu"

    def __init__(self):
        self.launches = 0

    def plain(self, wxy: torch.Tensor, rho: int) -> torch.Tensor:
        """``D = A @ B`` in float64, B's columns ``(wx, wy, qb, 0)``."""
        _check(wxy)
        wx, wy = wxy[:, 0].to(torch.int64), wxy[:, 1].to(torch.int64)
        b = pow2_floor(wy.clamp(min=1))
        qb = torch.div(wx, b, rounding_mode="floor") * b
        bmat = torch.stack([wx, wy, qb, torch.zeros_like(wx)]).to(torch.float64)
        a = torch.tensor([[rho, 0, rho, 0], [0, rho, 2 * rho, 0]], dtype=torch.float64,
                         device=wxy.device)  # rows 0 and 1 of A: D's x and y
        d = a @ bmat
        return d.t().to(torch.int64).to(torch.int32)

    def kernel(self, wxy: torch.Tensor, rho: int) -> torch.Tensor:
        """The map from ``hmap_mxu.cu``: 16 FP64 MMAs per 128 blocks."""
        t = _check(wxy)
        if wxy.device.type != "cuda":
            raise ValueError(f"hmap_mxu kernel takes CUDA tensors, got one on {wxy.device}")
        if not wxy.is_contiguous() or wxy.data_ptr() % 8:
            raise ValueError("hmap_mxu kernel needs a contiguous tensor aligned to 8 bytes")
        out = torch.empty_like(wxy)
        lib = _build.library()
        with torch.cuda.device(wxy.device):
            code = lib.hmap2_coords_mxu_launch(
                out.data_ptr(), wxy.data_ptr(), t, int(rho),
                torch.cuda.current_stream(wxy.device).cuda_stream)
        _build.check(code, self.name)
        self.launches += 1
        return out


HMAP_MXU = HmapMxuKernel()


def hmap2_coords_mxu(wxy, rho: int = 1, device=None) -> torch.Tensor:
    """``(T, 2)`` int32 grid coords -> ``(T, 2)`` int32 element origins.

    Implements ``D = A x B + C`` (Eq. 32); C, the intra-block offset, is
    zero.  Grid rows with ``wy = 0`` map through ``max(wy, 1)``.

    Args:
        wxy: ``(T, 2)`` int32 ``(wx, wy)`` per block, ``T % 128 == 0``.
        rho: Tile side: the origins are in elements.
        device: None for the card, ``'cpu'`` for the plain version.

    Returns:
        ``(T, 2)`` int32 ``(x, y)``.

    Raises:
        ValueError: ``wxy`` is not ``(T, 2)`` int32 with ``T % 128 == 0``.

    Example:
        >>> w = torch.tensor([[1, 2], [5, 0]] * 64, dtype=torch.int32)
        >>> hmap2_coords_mxu(w, rho=4, device="cpu")[:2].tolist()
        [[4, 8], [40, 40]]
    """
    wxy = torch.as_tensor(wxy, device=resolve_device(device))
    _check(wxy)
    if on_card(wxy, HMAP_MXU.name):
        return HMAP_MXU.kernel(wxy.contiguous(), rho)
    return HMAP_MXU.plain(wxy, rho)


def launch_counts() -> dict:
    """Launches of the tensor-core map since its counter was last 0.

    Example:
        >>> sorted(launch_counts())
        ['hmap_mxu']
    """
    return {HMAP_MXU.name: HMAP_MXU.launches}
