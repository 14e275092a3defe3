"""Blocks and the layer stack of the dense decoder.

A block is pre-norm attention plus a pre-norm SwiGLU, each added to the
residual stream.  The stack is ``n_periods`` repetitions of the config's
``period`` in an ``nn.ModuleList``, where the JAX package scans over
stacked leaves; each period is an ``nn.ModuleDict`` of blocks ``l0, l1,
...``, so a parameter's name is the JAX tree path with the period index
in front (``stack.3.l0.mixer.wq``).  Mixers other than GQA attention and
FFNs other than dense SwiGLU are ROADMAP A.8.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import Attention, attn_apply, init_kv_cache
from .layers import RMSNorm, SwiGLU, rmsnorm, swiglu

__all__ = ["Block", "block_init", "block_apply", "init_block_cache", "stack_init",
           "stack_apply", "check_spec"]


def check_spec(cfg, spec) -> None:
    """Raise unless the port has the block ``spec`` names.

    Raises:
        NotImplementedError: a mixer other than GQA attention or an FFN
            other than dense SwiGLU (ROADMAP A.8).
    """
    if spec.mixer != "attn" or spec.ffn != "dense" or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: block {spec} with {cfg.attention} attention is not ported; "
            "the port runs LayerSpec('attn', 'dense') with GQA (ROADMAP A.8)"
        )


class Block(nn.ModuleDict):
    """One ``LayerSpec('attn', 'dense')`` block's parameters:
    ``norm1``, ``mixer`` (GQA attention), ``norm2``, ``ffn`` (SwiGLU)."""

    def __init__(self, cfg, spec, dtype, device):
        check_spec(cfg, spec)
        d = cfg.d_model
        super().__init__({
            "norm1": RMSNorm(d, dtype, device),
            "mixer": Attention(cfg, dtype, device),
            "norm2": RMSNorm(d, dtype, device),
            "ffn": SwiGLU(d, cfg.d_ff, dtype, device),
        })

    def init(self, generator: torch.Generator) -> None:
        """Initialise every part from ``generator``, in a fixed order."""
        for name in ("norm1", "mixer", "norm2", "ffn"):
            self[name].init(generator)


def block_init(generator: torch.Generator, cfg, spec, dtype=torch.float32) -> Block:
    """A block on the generator's device, initialised from it."""
    p = Block(cfg, spec, dtype, generator.device)
    p.init(generator)
    return p


def block_apply(p, cfg, spec, x: torch.Tensor, positions: torch.Tensor, *,
                cache=None, mode: str = "train"):
    """Returns ``(x, new_cache)``; ``new_cache`` is ``{"mixer": ...}``
    in prefill and decode, ``{}`` in train.  ``spec`` is the one
    ``check_spec`` admits."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mixer_cache = cache.get("mixer") if cache else None
    o, new_mixer = attn_apply(p["mixer"], cfg, h, positions, cache=mixer_cache, mode=mode)
    x = x + o
    new_cache: Dict[str, Any] = {}
    if new_mixer is not None:
        new_cache["mixer"] = new_mixer
    x = x + swiglu(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x, new_cache


def init_block_cache(cfg, spec, batch: int, seq: int, dtype, device=None):
    """Zeroed decode cache of one block, ``{"mixer": (k, v)}``."""
    return {"mixer": init_kv_cache(cfg, batch, seq, dtype, device)}


def stack_init(cfg, specs: Sequence, n_periods: int, dtype, device) -> nn.ModuleList:
    """The period stack's parameters, uninitialised, on ``device``."""
    return nn.ModuleList(
        nn.ModuleDict({f"l{i}": Block(cfg, s, dtype, device) for i, s in enumerate(specs)})
        for _ in range(n_periods)
    )


def _period_apply(period, cfg, specs, x, positions, caches, mode):
    nc = {}
    for i, spec in enumerate(specs):
        c_i = caches.get(f"l{i}") if caches else None
        x, nc[f"l{i}"] = block_apply(period[f"l{i}"], cfg, spec, x, positions,
                                     cache=c_i, mode=mode)
    return x, nc


def stack_apply(params: nn.ModuleList, cfg, specs: Sequence, x: torch.Tensor,
                positions: torch.Tensor, *, caches: Optional[List] = None,
                mode: str = "train"):
    """Run the periods in order.  Returns ``(x, new_caches)``, one dict of
    block caches per period.

    ``cfg.remat`` acts where autograd records, as the reference's
    ``jax.checkpoint`` of the scanned period: ``"none"`` keeps every
    activation, ``"full"`` runs each period under
    ``torch.utils.checkpoint.checkpoint`` (its activations recomputed in
    the backward).

    Raises:
        NotImplementedError: ``remat="dots"`` (ROADMAP A.8.4).
        ValueError: an unknown ``remat``.
    """
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"{cfg.name}: remat must be 'none', 'full' or 'dots'; "
                         f"got {cfg.remat!r}")
    remat = cfg.remat != "none" and mode == "train" and torch.is_grad_enabled()
    if remat and cfg.remat == "dots":
        raise NotImplementedError(f"{cfg.name}: remat='dots' (save matrix products only) "
                                  "is ROADMAP A.8.4")
    new_caches = []
    for k, period in enumerate(params):
        c_k = caches[k] if caches else None
        if remat:
            x, nc = checkpoint(_period_apply, period, cfg, specs, x, positions, c_k, mode,
                               use_reentrant=False)
        else:
            x, nc = _period_apply(period, cfg, specs, x, positions, c_k, mode)
        new_caches.append(nc)
    return x, new_caches
