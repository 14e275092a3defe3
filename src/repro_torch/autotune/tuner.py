"""The attention decisions of the autotuner: tile and executor.

``attn_block_q`` picks the square tile of the flash kernel and
``choose_attn_impl`` the causal-attention executor, for
``models.attention.simplex_attention`` and ``ops.causal_flash_attention``.
Only the structural rules are ported: on the CPU the JAX package's
interpret-mode tile rule (so both packages walk the same tiles in the
tests), on the card the largest tile the CUDA kernel is built for whose
block fits its shared memory.  The roofline ranking with H100 constants,
the measured overlay and the disk cache arrive with ROADMAP A.5; until
then a mappable shape always runs the folded flash kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.flash_attention import kernel_fits
from ..kernels.policy import resolve_device

__all__ = ["AttnDecision", "attn_block_q", "choose_attn_impl"]

_ATTN_BLOCKS = (128, 64, 32, 16, 8)


@dataclass(frozen=True)
class AttnDecision:
    """One attention dispatch decision.

    Attributes:
        seq: Sequence length.
        heads: Query-head count.
        head_dim: Head dimension.
        device: Device type the decision is for (``'cuda'`` or ``'cpu'``).
        impl: ``'flash'`` or ``'chunked'``.
        kind: ``'folded'`` for flash, ``'chunked'`` otherwise.
        block_q: Square tile side for the flash kernel; 0 when none maps
            the shape.
        source: ``'rule'`` (a tile maps the shape) or ``'fallback'``
            (none does, so the chunked executor runs).
    """

    seq: int
    heads: int
    head_dim: int
    device: str
    impl: str
    kind: str
    block_q: int
    source: str


def attn_block_q(seq: int, head_dim: int, device=None, dtype=torch.float32) -> int:
    """Square attention tile side for a sequence length (0 if none fits).

    On the CPU: the largest of (128, 64, 32, 16, 8) dividing ``seq`` that
    still gives at least two query tiles (else the largest divisor), the
    JAX package's interpret rule.  On the card: the largest divisor a
    CUDA kernel is built for whose block, for ``dtype``, fits
    ``policy.SMEM_LIMIT``.

    Args:
        seq: Sequence length.
        head_dim: Attention head dimension.
        device: Device the kernel runs on; None means the card.
        dtype: The activations' dtype (the kernel and its shared memory
            depend on it on the card).

    Example:
        >>> attn_block_q(64, 16, device="cpu")   # two tiles: the fold runs
        32
        >>> attn_block_q(60, 16, device="cpu")
        0
    """
    dev = resolve_device(device)
    divisors = [bq for bq in _ATTN_BLOCKS if bq <= seq and seq % bq == 0]
    if dev.type == "cuda":
        divisors = [bq for bq in divisors if kernel_fits(bq, head_dim, dtype)]
        return divisors[0] if divisors else 0
    for bq in divisors:
        if seq // bq >= 2:
            return bq
    return divisors[0] if divisors else 0


def choose_attn_impl(seq: int, heads: int, head_dim: int, device=None,
                     dtype=torch.float32) -> AttnDecision:
    """Pick the causal-attention executor for ``(seq, heads, head_dim)``.

    The structural guard of the reference: no tile maps the shape, so
    the chunked executor runs (``source='fallback'``).  Otherwise the
    folded flash kernel runs; ranking it against ``bb`` and the chunked
    executor by cost waits for ROADMAP A.5.

    Example:
        >>> d = choose_attn_impl(64, 4, 16, device="cpu")
        >>> (d.impl, d.kind, d.block_q)
        ('flash', 'folded', 32)
    """
    dev = resolve_device(device)
    block = attn_block_q(seq, head_dim, dev, dtype)
    if not block:
        return AttnDecision(seq, heads, head_dim, dev.type, "chunked", "chunked", 0,
                            "fallback")
    return AttnDecision(seq, heads, head_dim, dev.type, "flash", "folded", block, "rule")
