"""The model as one ``nn.Module``: init, loss, prefill, decode, caches.

It mirrors the JAX package's ``Model`` for every architecture: the dense
family (yi-6b, granite-8b, internlm2-20b, stablelm-12b), the MoE models
(qwen2-moe-a2.7b; deepseek-v3-671b with MLA, its unrolled dense prefix
layers and the multi-token prediction head), the hybrid jamba-v0.1-52b
(Mamba, attention and MoE), xlstm-350m (mLSTM and sLSTM blocks), the
vision-language qwen2-vl-72b and the encoder-decoder
seamless-m4t-large-v2.  Token embedding, the prefix blocks, the period
stack, a final RMSNorm and an untied unembedding; the loss is the
next-token cross-entropy plus the experts' balance loss and, with
``cfg.mtp``, 0.3 times the MTP head's cross-entropy.

With ``cfg.n_patches``, a batch's ``patches`` (B, P, d), precomputed
patch embeddings, are prepended to the text and the attention takes
M-RoPE positions: a patch ``i`` sits at ``(0, i // side, i % side)`` and
text token ``j`` at ``(j + 1, j + side, j + side)``, ``side =
isqrt(P)``; decode gives all three streams the token's absolute
position, as the reference does.  With ``cfg.encoder_layers``, a batch's
``src_embeds`` (B, Sk, d), precomputed frame embeddings, run through a
bidirectional encoder stack and its final norm, and every decoder block
cross-attends to the result (prefill keeps its K/V in the caches).

The module holds the parameters; ``self.cfg`` is read on every call, so
swapping it (for example ``attention_impl``) changes the executor, not
the weights.

The parameters are made with ``requires_grad=False`` and ``prefill`` and
``decode`` run under ``torch.no_grad()``, so serving records no graph; a
trainer turns gradients on with ``model.requires_grad_(True)``.

``loss``, ``prefill`` and ``decode`` take a ``bind`` hook: each unit of
the model (``unit_of``: a period of the stack, a prefix block, a period
of the encoder, the MTP head) runs inside ``bind(unit)``, a context in
which the caller puts that unit's parameters in place, and each use of a
leaf outside every unit (an embedding lookup, a product with the
unembedding, a final norm) inside ``bind(name)``.  The step bundle
(``launch/steps.py``) gathers the parameters there and frees them after,
as the reference's scan gathers each period's inside its body.
"""

from __future__ import annotations

import math
import contextlib
from typing import Any, Callable, ContextManager, Dict, Optional

import torch
from torch import nn

from ..configs.base import LayerSpec
from ..kernels.policy import resolve_device
from .layers import Embed, Params, RMSNorm, dense_init, embed, rmsnorm
from .transformer import Block, block_apply, init_block_cache, stack_apply, stack_init

# The MTP head's block: attention (MLA under cfg.attention == "mla") and
# a dense FFN, as the reference's ``Model`` builds it.
MTP_SPEC = LayerSpec("attn", "dense")
# The weight of the MTP cross-entropy in the loss.
MTP_WEIGHT = 0.3
# The encoder's block: bidirectional attention and a dense FFN.
ENCODER_SPEC = LayerSpec("attn", "dense")

__all__ = ["Model", "unit_of"]

Bind = Optional[Callable[[str], ContextManager]]


def unit_of(name: str) -> Optional[str]:
    """The unit a parameter belongs to, by the name ``bind`` takes:
    ``stack.<k>``, ``prefix.p<i>``, ``encoder.stack.<k>`` or ``mtp``; None
    for the embedding, the unembedding and the final norms.

    Example:
        >>> unit_of("stack.3.l0.mixer.wq"), unit_of("mtp.block.ffn.w1"), unit_of("embed.e")
        ('stack.3', 'mtp', None)
    """
    parts = name.split(".")
    if parts[0] in ("stack", "prefix"):
        return ".".join(parts[:2])
    if parts[:2] == ["encoder", "stack"]:
        return ".".join(parts[:3])
    return "mtp" if parts[0] == "mtp" else None


def _in(bind: Bind, unit: str) -> ContextManager:
    return bind(unit) if bind else contextlib.nullcontext()


class MTP(Params):
    """DeepSeek-V3's depth-1 multi-token prediction head: ``proj`` (2 d,
    d), a ``block`` (``MTP_SPEC``) and a final ``norm``."""

    def __init__(self, cfg, dtype, device):
        super().__init__({"proj": (2 * cfg.d_model, cfg.d_model)}, dtype, device)
        self.block = Block(cfg, MTP_SPEC, dtype, device)
        self.norm = RMSNorm(cfg.d_model, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        """``proj``, then the block, then the norm."""
        dense_init(self["proj"].shape, generator, out=self["proj"].data)
        self.block.init(generator)
        self.norm.init(generator)


class Model(nn.Module):
    """An LM built from an ``ArchConfig``: a decoder, with an encoder
    where the config has ``encoder_layers``.

    Args:
        cfg: The architecture.
        device: Where the parameters live; None means the card.  The
            parameters are allocated, not initialised: call ``init``, or
            load them (``models.convert.params_from_jax``).
    """

    def __init__(self, cfg, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.specs = tuple(cfg.period)
        self.prefix_specs = tuple(cfg.prefix_spec)
        self.is_encdec = cfg.encoder_layers > 0
        self.pdtype = getattr(torch, cfg.param_dtype)
        self.adtype = getattr(torch, cfg.act_dtype)
        self.embed = Embed(cfg.vocab, cfg.d_model, self.pdtype, device)
        self.final_norm = RMSNorm(cfg.d_model, self.pdtype, device)
        self.stack = stack_init(cfg, self.specs, cfg.n_periods, self.pdtype, device,
                                cross=self.is_encdec)
        if self.prefix_specs:
            self.prefix = nn.ModuleDict({f"p{i}": Block(cfg, s, self.pdtype, device,
                                                        cross=self.is_encdec)
                                         for i, s in enumerate(self.prefix_specs)})
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                torch.empty((cfg.d_model, cfg.vocab), dtype=self.pdtype, device=device),
                requires_grad=False)
        if self.is_encdec:
            self.encoder = nn.ModuleDict({
                "stack": stack_init(cfg, (ENCODER_SPEC,), cfg.encoder_layers, self.pdtype,
                                    device),
                "final_norm": RMSNorm(cfg.d_model, self.pdtype, device)})
        if cfg.mtp:
            self.mtp = MTP(cfg, self.pdtype, device)

    @property
    def device(self) -> torch.device:
        """The device the parameters live on."""
        return self.final_norm["w"].device

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter from ``generator`` (on the model's device):
        the embedding, then the prefix blocks and each period's blocks in
        order, the final norm, the unembedding, the encoder's blocks and
        final norm, and the MTP head.  Returns the model."""
        self.embed.init(generator)
        for i in range(len(self.prefix_specs)):
            self.prefix[f"p{i}"].init(generator)
        for period in self.stack:
            for i in range(len(self.specs)):
                period[f"l{i}"].init(generator)
        self.final_norm.init(generator)
        if not self.cfg.tie_embeddings:
            dense_init(self.unembed.shape, generator, out=self.unembed.data)
        if self.is_encdec:
            for period in self.encoder["stack"]:
                period["l0"].init(generator)
            self.encoder["final_norm"].init(generator)
        if self.cfg.mtp:
            self.mtp.init(generator)
        return self

    # ------------------------------------------------------------ embeddings

    def _embed(self, tokens: torch.Tensor, bind: Bind = None) -> torch.Tensor:
        with _in(bind, "embed.e"):
            return embed(self.embed, tokens, self.adtype)

    def _embed_inputs(self, batch, bind: Bind = None):
        """Returns ``(embeds (B, S, d), positions (B, S), positions3 (B, S,
        3) or None)``; with ``cfg.n_patches`` the batch's ``patches`` come
        first and take M-RoPE positions."""
        tokens = batch["tokens"]
        x = self._embed(tokens, bind)
        positions3 = None
        if self.cfg.n_patches and "patches" in batch:
            x = torch.cat([batch["patches"].to(self.adtype), x], dim=1)
            positions3 = self._mrope_positions(x.shape[1], x.device)[None].expand(
                x.shape[0], -1, -1)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return x, positions, positions3

    def _mrope_positions(self, s: int, device) -> torch.Tensor:
        """(S, 3) int32 ``(t, h, w)`` positions: the patches on their grid at
        t = 0, then the text after it."""
        p = self.cfg.n_patches
        side = math.isqrt(p) or 1
        grid = torch.arange(p, device=device)
        text = torch.arange(s - p, device=device) + 1
        t = torch.cat([torch.zeros_like(grid), text])
        hh = torch.cat([grid // side, text + (side - 1)])
        ww = torch.cat([grid % side, text + (side - 1)])
        return torch.stack([t, hh, ww], dim=-1).to(torch.int32)

    def _logits(self, x: torch.Tensor, bind: Bind = None) -> torch.Tensor:
        with _in(bind, "embed.e" if self.cfg.tie_embeddings else "unembed"):
            w = self.embed["e"].T if self.cfg.tie_embeddings else self.unembed
            return x @ w.to(self.adtype)

    def _backbone(self, x, positions, *, caches=None, mode="train", enc_out=None,
                  positions3=None, mesh=None, keep=None, bind: Bind = None):
        """The prefix blocks, then the stack, then the final norm; returns
        ``(x, new_caches, aux)``.  ``mesh`` goes to every block and
        ``keep`` to ``stack_apply``; each unit runs inside ``bind``."""
        cfg = self.cfg
        new_caches: Dict[str, Any] = {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.prefix_specs:
            pc = {}
            for i, spec in enumerate(self.prefix_specs):
                c_i = caches["prefix"][f"p{i}"] if caches else None
                cross_cache = c_i.get("cross") if (c_i and mode == "decode") else None
                with _in(bind, f"prefix.p{i}"):
                    x, pc[f"p{i}"], a = block_apply(
                        self.prefix[f"p{i}"], cfg, spec, x, positions, cache=c_i, mode=mode,
                        enc_out=enc_out, cross_cache=cross_cache, positions3=positions3,
                        mesh=mesh)
                if cross_cache is not None:
                    pc[f"p{i}"]["cross"] = cross_cache
                aux = aux + a
            new_caches["prefix"] = pc
        x, new_caches["stack"], a = stack_apply(
            self.stack, cfg, self.specs, x, positions,
            caches=caches["stack"] if caches else None, mode=mode, enc_out=enc_out,
            positions3=positions3, mesh=mesh, keep=keep,
            bind=(lambda k: bind(f"stack.{k}")) if bind else None)
        with _in(bind, "final_norm.w"):
            x = rmsnorm(self.final_norm, x, cfg.norm_eps)
        return x, new_caches, aux + a

    def _encode(self, src_embeds: torch.Tensor, bind: Bind = None) -> torch.Tensor:
        """The encoder over ``src_embeds`` (B, Sk, d): bidirectional, in the
        train mode (no caches) in every mode of the model, as the
        reference runs it; each period inside ``bind``."""
        cfg = self.cfg
        b, s, _ = src_embeds.shape
        positions = torch.arange(s, device=src_embeds.device)[None].expand(b, s)
        x, _, _ = stack_apply(self.encoder["stack"], cfg, (ENCODER_SPEC,),
                              src_embeds.to(self.adtype), positions, mode="train",
                              bidirectional=True,
                              bind=(lambda k: bind(f"encoder.stack.{k}")) if bind else None)
        with _in(bind, "encoder.final_norm.w"):
            return rmsnorm(self.encoder["final_norm"], x, cfg.norm_eps)

    # ------------------------------------------------------------------ loss

    def loss(self, batch: Dict[str, torch.Tensor], mesh=None, bind: Bind = None):
        """Next-token cross-entropy plus the extra terms, as the
        reference's ``Model.loss``.

        Args:
            batch: ``{"tokens": (B, S+1)}`` integer tensor on the model's
                device: the inputs are ``[:, :-1]``, the labels ``[:, 1:]``;
                plus ``"patches"`` (B, P, d) with ``cfg.n_patches`` (the
                loss reads only the text positions) and ``"src_embeds"``
                (B, Sk, d) with ``cfg.encoder_layers``.  On a mesh, this
                rank's rows.
            mesh: A ``DeviceMesh`` for the mesh forms of the causal
                attention and the MoE FFN (``launch/steps.py``), or None.
            bind: Each unit runs inside ``bind(unit)`` (``unit_of``), and
                each use of a leaf outside every unit inside ``bind(its
                name)``; or None.

        Returns:
            ``(total, {"ce": ce, "aux": aux})``, float32 scalars; ``aux``
            is the sum of the MoE layers' balance losses (0 for a dense
            model), and ``total = ce + aux``, plus ``MTP_WEIGHT`` times the
            MTP head's cross-entropy with ``cfg.mtp``.
        """
        tokens = batch["tokens"]
        labels = tokens[:, 1:]
        x, positions, pos3 = self._embed_inputs({**batch, "tokens": tokens[:, :-1]}, bind)
        enc_out = self._encode(batch["src_embeds"], bind) if self.is_encdec else None
        h, _, aux = self._backbone(x, positions, mode="train", enc_out=enc_out,
                                   positions3=pos3, mesh=mesh, bind=bind)
        h_text = h[:, -labels.shape[1]:]  # the text positions, after any patches
        ce = _cross_entropy(self._logits(h_text, bind), labels)
        total = ce + aux
        if self.cfg.mtp:
            total = total + MTP_WEIGHT * self._mtp_loss(h_text, tokens, mesh, bind)
        return total, {"ce": ce, "aux": aux}

    def _mtp_loss(self, h: torch.Tensor, tokens: torch.Tensor, mesh=None,
                  bind: Bind = None) -> torch.Tensor:
        """DeepSeek-V3's multi-token prediction: the depth-1 head predicts
        token t+2 from ``[h_t ; embed(token_{t+1})]``."""
        cfg = self.cfg
        emb_next = self._embed(tokens[:, 1:-1], bind)
        with _in(bind, "mtp"):
            x = torch.cat([h[:, :-1], emb_next], dim=-1) @ self.mtp["proj"].to(self.adtype)
            b, s, _ = x.shape
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
            x, _, _ = block_apply(self.mtp.block, cfg, MTP_SPEC, x, positions, mode="train",
                                  mesh=mesh)
            x = rmsnorm(self.mtp.norm, x, cfg.norm_eps)
        return _cross_entropy(self._logits(x, bind), tokens[:, 2:])

    # ------------------------------------------------------- prefill / decode

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], mesh=None, keep=None, bind: Bind = None):
        """Full-sequence forward filling the caches.

        Args:
            batch: ``{"tokens": (B, S)}`` integer tensor on the model's
                device, plus ``"patches"`` and ``"src_embeds"`` as ``loss``
                takes them.
            mesh: As ``loss`` takes it.
            keep: Given to ``stack_apply``: each period's caches are
                ``keep(k, caches)``.
            bind: As ``loss`` takes it.

        Returns:
            ``(last_logits (B, 1, vocab), caches)`` with ``caches =
            {"stack": [{"l0": {"mixer": ...}}, ...]}``, one entry per
            period, and ``caches["prefix"] = {"p0": {"mixer": ...}, ...}``
            where the config has prefix layers.  A GQA block's cache is
            ``(k, v)``, an MLA block's ``(c_kv, k_pe)``, a Mamba block's
            ``(ssm state, conv tail)``, an mLSTM block's ``(C, n, m, conv
            tail)``, an sLSTM block's ``(c, n, h, m)``; a block with cross
            attention also keeps the encoder's ``(k, v)`` as ``"cross"``.
        """
        x, positions, pos3 = self._embed_inputs(batch, bind)
        enc_out = self._encode(batch["src_embeds"], bind) if self.is_encdec else None
        h, caches, _ = self._backbone(x, positions, mode="prefill", enc_out=enc_out,
                                      positions3=pos3, mesh=mesh, keep=keep, bind=bind)
        return self._logits(h[:, -1:], bind), caches

    @torch.no_grad()
    def decode(self, caches, batch: Dict[str, torch.Tensor], mesh=None, keep=None,
               bind: Bind = None):
        """One token against full caches.

        Args:
            caches: What ``prefill`` (or ``init_cache``) returned.
            batch: ``{"tokens": (B, 1), "pos": (B,)}``: the new token and
                its absolute position (with M-RoPE, the position of all
                three streams).
            mesh: As ``loss`` takes it.
            keep: Given to ``stack_apply``: each period's caches are
                ``keep(k, caches)``.
            bind: As ``loss`` takes it.

        Returns:
            ``(logits (B, 1, vocab), new_caches)``; a GQA block's new cache
            is ``(kc, vc, k, v)`` and an MLA block's ``(c_kv, k_pe,
            c_kv_new, k_pe_new)``, for a caller that appends; a Mamba,
            mLSTM or sLSTM block's is its stepped state; ``"cross"`` is
            carried as it is.
        """
        x = self._embed(batch["tokens"], bind)
        positions = batch["pos"][:, None]
        pos3 = None
        if self.cfg.mrope_sections is not None:
            pos3 = positions[..., None].expand(x.shape[0], 1, 3).to(torch.int32)
        h, new_caches, _ = self._backbone(x, positions, caches=caches, mode="decode",
                                          positions3=pos3, mesh=mesh, keep=keep, bind=bind)
        return self._logits(h, bind), new_caches

    # ----------------------------------------------------------------- caches

    def init_cache(self, batch: int, seq: int, dtype: Optional[torch.dtype] = None):
        """Zeroed caches of the ``prefill`` layout on the model's device
        (``"cross"`` in every block of an encoder-decoder model)."""
        dtype = dtype or self.adtype

        def blocks(specs, name):
            return {f"{name}{i}": init_block_cache(self.cfg, s, batch, seq, dtype, self.device,
                                                   cross=self.is_encdec)
                    for i, s in enumerate(specs)}

        caches: Dict[str, Any] = {"stack": [blocks(self.specs, "l")
                                            for _ in range(self.cfg.n_periods)]}
        if self.prefix_specs:
            caches["prefix"] = blocks(self.prefix_specs, "p")
        return caches


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of ``logsumexp(logits) - logits[label]`` in float32."""
    lf = logits.to(torch.float32)
    ll = lf.gather(-1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(lf, dim=-1) - ll).mean()
