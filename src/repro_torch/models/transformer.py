"""Blocks and the layer stack of the decoder.

A block is a pre-norm mixer (GQA attention, MLA or Mamba) plus a pre-norm
FFN (dense SwiGLU or MoE), each added to the residual stream.  The stack
is ``n_periods`` repetitions of the config's ``period`` in an
``nn.ModuleList``, where the JAX package scans over stacked leaves; each
period is an ``nn.ModuleDict`` of blocks ``l0, l1, ...``, so a
parameter's name is the JAX tree path with the period index in front
(``stack.3.l0.mixer.wq``).  Every block returns the MoE balance loss it
adds (0 without experts), and the stack sums them, as the reference's
scan carries them.  The xLSTM mixers and cross attention are ROADMAP
A.8.3.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import Attention, attn_apply, init_kv_cache
from .layers import RMSNorm, SwiGLU, rmsnorm, swiglu
from .mamba import Mamba, init_mamba_cache, mamba_apply
from .mla import MLA, init_mla_cache, mla_apply
from .moe import MoE, moe_apply

__all__ = ["Block", "block_init", "block_apply", "init_block_cache", "stack_init",
           "stack_apply", "check_spec"]


def check_spec(cfg, spec) -> None:
    """Raise unless the port has the block ``spec`` names.

    Raises:
        NotImplementedError: an xLSTM mixer (``mlstm``, ``slstm``;
            ROADMAP A.8.3).
        ValueError: an unknown mixer, FFN or attention.
    """
    if spec.mixer in ("mlstm", "slstm"):
        raise NotImplementedError(
            f"{cfg.name}: the {spec.mixer} mixer is not ported; the port runs attention "
            "(GQA or MLA) and Mamba blocks (ROADMAP A.8.3)")
    if (spec.mixer not in ("attn", "mamba") or spec.ffn not in ("dense", "moe")
            or cfg.attention not in ("gqa", "mla")):
        raise ValueError(f"{cfg.name}: unknown block {spec} with {cfg.attention} attention")


class Block(nn.ModuleDict):
    """One block's parameters: ``norm1``, ``mixer`` (GQA attention, MLA or
    Mamba), ``norm2`` and ``ffn`` (SwiGLU or MoE)."""

    def __init__(self, cfg, spec, dtype, device):
        check_spec(cfg, spec)
        d = cfg.d_model
        if spec.mixer == "mamba":
            mixer = Mamba(cfg, dtype, device)
        elif cfg.attention == "mla":
            mixer = MLA(cfg, dtype, device)
        else:
            mixer = Attention(cfg, dtype, device)
        ffn = (MoE(cfg, dtype, device) if spec.ffn == "moe"
               else SwiGLU(d, cfg.d_ff, dtype, device))
        super().__init__({"norm1": RMSNorm(d, dtype, device), "mixer": mixer,
                          "norm2": RMSNorm(d, dtype, device), "ffn": ffn})

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
    """Returns ``(x, new_cache, aux)``: ``new_cache`` is ``{"mixer": ...}``
    in prefill and decode, ``{}`` in train; ``aux`` is the block's MoE
    balance loss (a float32 scalar, 0 without experts).  ``spec`` is one
    ``check_spec`` admits."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mixer_cache = cache.get("mixer") if cache else None
    if spec.mixer == "mamba":
        o, new_mixer = mamba_apply(p["mixer"], cfg, h, cache=mixer_cache, mode=mode)
    elif cfg.attention == "mla":
        o, new_mixer = mla_apply(p["mixer"], cfg, h, positions, cache=mixer_cache, mode=mode)
    else:
        o, new_mixer = attn_apply(p["mixer"], cfg, h, positions, cache=mixer_cache,
                                  mode=mode)
    x = x + o
    new_cache: Dict[str, Any] = {}
    if new_mixer is not None:
        new_cache["mixer"] = new_mixer
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == "moe":
        o, aux = moe_apply(p["ffn"], cfg, h)
    else:
        o = swiglu(p["ffn"], h)
    return x + o, new_cache, aux


def init_block_cache(cfg, spec, batch: int, seq: int, dtype, device=None):
    """Zeroed decode cache of one block: ``{"mixer": (k, v)}`` for GQA
    attention, the latent pair for MLA, the SSM state and conv tail for
    Mamba."""
    if spec.mixer == "mamba":
        return {"mixer": init_mamba_cache(cfg, batch, dtype, device)}
    if cfg.attention == "mla":
        return {"mixer": init_mla_cache(cfg, batch, seq, dtype, device)}
    return {"mixer": init_kv_cache(cfg, batch, seq, dtype, device)}


def stack_init(cfg, specs: Sequence, n_periods: int, dtype, device) -> nn.ModuleList:
    """The period stack's parameters, uninitialised, on ``device``."""
    return nn.ModuleList(
        nn.ModuleDict({f"l{i}": Block(cfg, s, dtype, device) for i, s in enumerate(specs)})
        for _ in range(n_periods)
    )


def _period_apply(period, cfg, specs, x, positions, caches, mode):
    nc = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(specs):
        c_i = caches.get(f"l{i}") if caches else None
        x, nc[f"l{i}"], a = block_apply(period[f"l{i}"], cfg, spec, x, positions,
                                        cache=c_i, mode=mode)
        aux = aux + a
    return x, nc, aux


def stack_apply(params: nn.ModuleList, cfg, specs: Sequence, x: torch.Tensor,
                positions: torch.Tensor, *, caches: Optional[List] = None,
                mode: str = "train"):
    """Run the periods in order.  Returns ``(x, new_caches, aux)``: one
    dict of block caches per period, and the sum of the blocks' balance
    losses (float32).

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
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for k, period in enumerate(params):
        c_k = caches[k] if caches else None
        if remat:
            x, nc, a = checkpoint(_period_apply, period, cfg, specs, x, positions, c_k, mode,
                                  use_reentrant=False)
        else:
            x, nc, a = _period_apply(period, cfg, specs, x, positions, c_k, mode)
        new_caches.append(nc)
        aux = aux + a
    return x, new_caches, aux
