"""Blocks and the layer stacks of the decoder and the encoder.

A block is a pre-norm mixer (GQA attention, MLA, Mamba, mLSTM or sLSTM),
in an encoder-decoder model a pre-norm cross attention to the encoder's
output, and a pre-norm FFN (dense SwiGLU, MoE, or none for the xLSTM
blocks), each added to the residual stream.  The stack is ``n_periods``
repetitions of the config's ``period`` in an ``nn.ModuleList``, where the
JAX package scans over stacked leaves; each period is an
``nn.ModuleDict`` of blocks ``l0, l1, ...``, so a parameter's name is the
JAX tree path with the period index in front (``stack.3.l0.mixer.wq``).
Every block returns the MoE balance loss it adds (0 without experts), and
the stack sums them, as the reference's scan carries them.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, ContextManager, Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention import Attention, attn_apply, init_kv_cache
from .layers import RMSNorm, SwiGLU, rmsnorm, swiglu
from .mamba import Mamba, init_mamba_cache, mamba_apply
from .mla import MLA, init_mla_cache, mla_apply
from .moe import MoE, moe_apply
from .xlstm import (MLSTM, SLSTM, init_mlstm_cache, init_slstm_cache, mlstm_apply,
                    slstm_apply)

__all__ = ["Block", "block_init", "block_apply", "init_block_cache", "stack_init",
           "stack_apply", "check_spec"]


def check_spec(cfg, spec) -> None:
    """Raise unless ``spec`` names a block of the reference.

    Raises:
        ValueError: an unknown mixer, FFN or attention.
    """
    if (spec.mixer not in ("attn", "mamba", "mlstm", "slstm")
            or spec.ffn not in ("dense", "moe", "none") or cfg.attention not in ("gqa", "mla")):
        raise ValueError(f"{cfg.name}: unknown block {spec} with {cfg.attention} attention")


class Block(nn.ModuleDict):
    """One block's parameters: ``norm1``, ``mixer`` (GQA attention, MLA,
    Mamba, mLSTM or sLSTM), with ``cross`` the cross attention's
    ``norm_x`` and ``cross``, and unless ``spec.ffn`` is ``"none"``,
    ``norm2`` and ``ffn`` (SwiGLU or MoE)."""

    def __init__(self, cfg, spec, dtype, device, cross: bool = False):
        check_spec(cfg, spec)
        d = cfg.d_model
        if spec.mixer == "mamba":
            mixer = Mamba(cfg, dtype, device)
        elif spec.mixer == "mlstm":
            mixer = MLSTM(cfg, dtype, device)
        elif spec.mixer == "slstm":
            mixer = SLSTM(cfg, dtype, device)
        elif cfg.attention == "mla":
            mixer = MLA(cfg, dtype, device)
        else:
            mixer = Attention(cfg, dtype, device)
        parts = {"norm1": RMSNorm(d, dtype, device), "mixer": mixer}
        if cross:
            parts.update(norm_x=RMSNorm(d, dtype, device), cross=Attention(cfg, dtype, device))
        if spec.ffn != "none":
            parts.update(norm2=RMSNorm(d, dtype, device),
                         ffn=(MoE(cfg, dtype, device) if spec.ffn == "moe"
                              else SwiGLU(d, cfg.d_ff, dtype, device)))
        super().__init__(parts)

    def init(self, generator: torch.Generator) -> None:
        """Initialise every part from ``generator``, in a fixed order."""
        for name in ("norm1", "mixer", "norm_x", "cross", "norm2", "ffn"):
            if name in self:
                self[name].init(generator)


def block_init(generator: torch.Generator, cfg, spec, dtype=torch.float32,
               cross: bool = False) -> Block:
    """A block on the generator's device, initialised from it."""
    p = Block(cfg, spec, dtype, generator.device, cross=cross)
    p.init(generator)
    return p


def block_apply(p, cfg, spec, x: torch.Tensor, positions: torch.Tensor, *,
                cache=None, mode: str = "train", enc_out: Optional[torch.Tensor] = None,
                cross_cache=None, bidirectional: bool = False,
                positions3: Optional[torch.Tensor] = None, mesh=None):
    """Returns ``(x, new_cache, aux)``: ``new_cache`` is ``{"mixer": ...}``
    in prefill and decode, ``{}`` in train; ``aux`` is the block's MoE
    balance loss (a float32 scalar, 0 without experts).  ``spec`` is one
    ``check_spec`` admits.

    A block with cross attention attends to ``enc_out`` (B, Sk, d), whose
    K/V it projects once and, in prefill, returns as ``new_cache["cross"]``;
    in decode it reads them from ``cross_cache``.  ``bidirectional`` and
    ``positions3`` go to the attention mixer, and ``mesh`` (a
    ``DeviceMesh`` or None) to the causal attention and the MoE FFN, whose
    mesh forms it selects.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mixer_cache = cache.get("mixer") if cache else None
    if spec.mixer == "mamba":
        o, new_mixer = mamba_apply(p["mixer"], cfg, h, cache=mixer_cache, mode=mode)
    elif spec.mixer == "mlstm":
        o, new_mixer = mlstm_apply(p["mixer"], cfg, h, cache=mixer_cache, mode=mode)
    elif spec.mixer == "slstm":
        o, new_mixer = slstm_apply(p["mixer"], cfg, h, cache=mixer_cache, mode=mode)
    elif cfg.attention == "mla":
        o, new_mixer = mla_apply(p["mixer"], cfg, h, positions, cache=mixer_cache, mode=mode,
                                 mesh=mesh)
    else:
        o, new_mixer = attn_apply(p["mixer"], cfg, h, positions, cache=mixer_cache,
                                  mode=mode, bidirectional=bidirectional,
                                  positions3=positions3, mesh=mesh)
    x = x + o
    new_cache: Dict[str, Any] = {}
    if new_mixer is not None:
        new_cache["mixer"] = new_mixer
    if ("cross" in p and enc_out is not None) or cross_cache is not None:
        hx = rmsnorm(p["norm_x"], x, cfg.norm_eps)
        if cross_cache is not None:
            kv = cross_cache
        else:  # project the encoder's output once (train and prefill)
            b, sk, _ = enc_out.shape
            hkv, hd, dt = cfg.n_kv_heads, cfg.hd, x.dtype
            kv = tuple((enc_out @ p["cross"][w].to(dt)).reshape(b, sk, hkv, hd).transpose(1, 2)
                       for w in ("wk", "wv"))
            if mode in ("prefill", "decode"):
                new_cache["cross"] = kv
        o, _ = attn_apply(p["cross"], cfg, hx, positions, mode=mode, cross_kv=kv)
        x = x + o
    if spec.ffn == "none":
        return x, new_cache, aux
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == "moe":
        o, aux = moe_apply(p["ffn"], cfg, h, mesh)
    else:
        o = swiglu(p["ffn"], h)
    return x + o, new_cache, aux


def init_block_cache(cfg, spec, batch: int, seq: int, dtype, device=None,
                     cross: bool = False):
    """Zeroed decode cache of one block: ``{"mixer": ...}`` (GQA's ``(k,
    v)``, MLA's latent pair, Mamba's SSM state and conv tail, the mLSTM's
    ``(C, n, m, conv tail)``, the sLSTM's ``(c, n, h, m)``), and with
    ``cross`` the encoder's K/V as ``"cross"``, each (batch, Hkv, seq,
    hd)."""
    if spec.mixer == "mamba":
        c = {"mixer": init_mamba_cache(cfg, batch, dtype, device)}
    elif spec.mixer == "mlstm":
        c = {"mixer": init_mlstm_cache(cfg, batch, dtype, device)}
    elif spec.mixer == "slstm":
        c = {"mixer": init_slstm_cache(cfg, batch, dtype, device)}
    elif cfg.attention == "mla":
        c = {"mixer": init_mla_cache(cfg, batch, seq, dtype, device)}
    else:
        c = {"mixer": init_kv_cache(cfg, batch, seq, dtype, device)}
    if cross:
        c["cross"] = init_kv_cache(cfg, batch, seq, dtype, device)
    return c


def stack_init(cfg, specs: Sequence, n_periods: int, dtype, device,
               cross: bool = False) -> nn.ModuleList:
    """The period stack's parameters, uninitialised, on ``device``; with
    ``cross`` every block has cross attention."""
    return nn.ModuleList(
        nn.ModuleDict({f"l{i}": Block(cfg, s, dtype, device, cross=cross)
                       for i, s in enumerate(specs)})
        for _ in range(n_periods)
    )


def _period_apply(period, cfg, specs, x, positions, caches, mode, enc_out, bidirectional,
                  positions3, mesh):
    nc = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(specs):
        c_i = caches.get(f"l{i}") if caches else None
        cross_cache = c_i.get("cross") if (c_i and mode == "decode") else None
        x, nc[f"l{i}"], a = block_apply(period[f"l{i}"], cfg, spec, x, positions,
                                        cache=c_i, mode=mode, enc_out=enc_out,
                                        cross_cache=cross_cache,
                                        bidirectional=bidirectional, positions3=positions3,
                                        mesh=mesh)
        if cross_cache is not None:
            nc[f"l{i}"]["cross"] = cross_cache  # the encoder's K/V stay as they are
        aux = aux + a
    return x, nc, aux


def _bound_period(bind, k, *args):
    """``_period_apply`` with period ``k``'s parameters bound by ``bind``."""
    with bind(k):
        return _period_apply(*args)


# The matrix products without a batch dimension: what remat "dots" saves,
# as the reference's ``checkpoint_dots_with_no_batch_dims`` does.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def stack_apply(params: nn.ModuleList, cfg, specs: Sequence, x: torch.Tensor,
                positions: torch.Tensor, *, caches: Optional[List] = None,
                mode: str = "train", enc_out: Optional[torch.Tensor] = None,
                bidirectional: bool = False, positions3: Optional[torch.Tensor] = None,
                mesh=None, keep: Optional[Callable[[int, Any], Any]] = None,
                bind: Optional[Callable[[int], ContextManager]] = None):
    """Run the periods in order.  Returns ``(x, new_caches, aux)``: one
    dict of block caches per period, and the sum of the blocks' balance
    losses (float32).  ``enc_out``, ``bidirectional``, ``positions3`` and
    ``mesh`` go to every block (``block_apply``).  ``caches`` is indexed
    by period, once each, in order.  With ``keep``, period ``k``'s entry
    of ``new_caches`` is ``keep(k, its caches)``, called as soon as the
    period has run, so that a caller can store each period's caches
    elsewhere and free them (the step bundle's placement).  With
    ``bind``, period ``k`` runs inside ``bind(k)``, a context in which its
    parameters are in place (the step bundle gathers them there and frees
    them after); under remat the context is inside what the backward
    runs again, so the recompute binds them again.

    ``cfg.remat`` acts where autograd records, as the reference's
    ``jax.checkpoint`` of the scanned period: ``"none"`` keeps every
    activation, ``"full"`` runs each period under
    ``torch.utils.checkpoint.checkpoint`` (its activations recomputed in
    the backward), and ``"dots"`` under a selective checkpoint that saves
    the outputs of the matrix products with no batch dimension (``mm``,
    ``addmm``: the projections) and recomputes the rest, batched
    products (``bmm``: attention, the experts) included.

    Raises:
        ValueError: an unknown ``remat``.
    """
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"{cfg.name}: remat must be 'none', 'full' or 'dots'; "
                         f"got {cfg.remat!r}")
    remat = cfg.remat != "none" and mode == "train" and torch.is_grad_enabled()
    context = {"context_fn": _dots_context} if cfg.remat == "dots" else {}
    new_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for k, period in enumerate(params):
        args = (period, cfg, specs, x, positions, caches[k] if caches else None, mode, enc_out,
                bidirectional, positions3, mesh)
        fn = functools.partial(_bound_period, bind, k) if bind else _period_apply
        if remat:
            x, nc, a = checkpoint(fn, *args, use_reentrant=False, **context)
        else:
            x, nc, a = fn(*args)
        new_caches.append(keep(k, nc) if keep else nc)
        aux = aux + a
        del args, nc  # a kept period's caches are freed before the next runs
    return x, new_caches, aux
