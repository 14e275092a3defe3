"""The dense decoder as one ``nn.Module``: init, prefill, decode, caches.

It mirrors the JAX package's ``Model`` for decoder-only dense configs
(yi-6b, granite-8b, internlm2-20b, stablelm-12b): token embedding, the
period stack, a final RMSNorm and an untied unembedding, and the
next-token loss.  Patches, the encoder and multi-token prediction wait
for their slices (ROADMAP A.8).  The module holds the parameters;
``self.cfg`` is read on every call, so swapping it (for example
``attention_impl``) changes the executor, not the weights.

The parameters are made with ``requires_grad=False`` and ``prefill`` and
``decode`` run under ``torch.no_grad()``, so serving records no graph; a
trainer turns gradients on with ``model.requires_grad_(True)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..kernels.policy import resolve_device
from .layers import Embed, RMSNorm, dense_init, embed, rmsnorm
from .transformer import check_spec, init_block_cache, stack_apply, stack_init

__all__ = ["Model"]


def _check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    unported = [
        name for name, on in (
            ("prefix layers", cfg.n_prefix or cfg.prefix_spec),
            ("an encoder", cfg.encoder_layers),
            ("patch embeddings", cfg.n_patches),
            ("multi-token prediction", cfg.mtp),
            ("M-RoPE", cfg.mrope_sections is not None),
        ) if on
    ]
    if unported:
        raise NotImplementedError(f"{cfg.name}: {', '.join(unported)} not ported "
                                  "(ROADMAP A.8)")
    for spec in cfg.period:
        check_spec(cfg, spec)


class Model(nn.Module):
    """A dense decoder-only LM built from an ``ArchConfig``.

    Args:
        cfg: The architecture.
        device: Where the parameters live; None means the card.  The
            parameters are allocated, not initialised: call ``init``, or
            load them (``models.convert.params_from_jax``).
    """

    def __init__(self, cfg, device=None):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.specs = tuple(cfg.period)
        self.pdtype = getattr(torch, cfg.param_dtype)
        self.adtype = getattr(torch, cfg.act_dtype)
        self.embed = Embed(cfg.vocab, cfg.d_model, self.pdtype, device)
        self.final_norm = RMSNorm(cfg.d_model, self.pdtype, device)
        self.stack = stack_init(cfg, self.specs, cfg.n_periods, self.pdtype, device)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                torch.empty((cfg.d_model, cfg.vocab), dtype=self.pdtype, device=device),
                requires_grad=False)

    @property
    def device(self) -> torch.device:
        """The device the parameters live on."""
        return self.final_norm["w"].device

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter from ``generator`` (on the model's device):
        the embedding, then each block in order, the final norm and the
        unembedding.  Returns the model."""
        self.embed.init(generator)
        for period in self.stack:
            for i in range(len(self.specs)):
                period[f"l{i}"].init(generator)
        self.final_norm.init(generator)
        if not self.cfg.tie_embeddings:
            dense_init(self.unembed.shape, generator, out=self.unembed.data)
        return self

    # ------------------------------------------------------------ embeddings

    def _embed_inputs(self, batch):
        """Returns ``(embeds (B, S, d), positions (B, S))``."""
        tokens = batch["tokens"]
        x = embed(self.embed, tokens, self.adtype)
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        return x, positions

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embed["e"].T if self.cfg.tie_embeddings else self.unembed
        return x @ w.to(self.adtype)

    def _backbone(self, x, positions, *, caches=None, mode="train"):
        x, new_caches = stack_apply(self.stack, self.cfg, self.specs, x, positions,
                                    caches=caches["stack"] if caches else None, mode=mode)
        return rmsnorm(self.final_norm, x, self.cfg.norm_eps), {"stack": new_caches}

    # ------------------------------------------------------------------ loss

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Next-token cross-entropy, as the reference's ``Model.loss``.

        Args:
            batch: ``{"tokens": (B, S+1)}`` integer tensor on the model's
                device: the inputs are ``[:, :-1]``, the labels ``[:, 1:]``.

        Returns:
            ``(total, {"ce": ce, "aux": aux})``, float32 scalars; ``aux``
            (the experts' balance loss) is 0 for a dense model, and
            ``total = ce + aux``.
        """
        tokens = batch["tokens"]
        labels = tokens[:, 1:]
        x, positions = self._embed_inputs({"tokens": tokens[:, :-1]})
        h, _ = self._backbone(x, positions, mode="train")
        ce = _cross_entropy(self._logits(h[:, -labels.shape[1]:]), labels)
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------- prefill / decode

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """Full-sequence forward filling the caches.

        Args:
            batch: ``{"tokens": (B, S)}`` integer tensor on the model's
                device.

        Returns:
            ``(last_logits (B, 1, vocab), caches)`` with ``caches =
            {"stack": [{"l0": {"mixer": (k, v)}}, ...]}``, one entry per
            period.
        """
        x, positions = self._embed_inputs(batch)
        h, caches = self._backbone(x, positions, mode="prefill")
        return self._logits(h[:, -1:]), caches

    @torch.no_grad()
    def decode(self, caches, batch: Dict[str, torch.Tensor]):
        """One token against full caches.

        Args:
            caches: What ``prefill`` (or ``init_cache``) returned.
            batch: ``{"tokens": (B, 1), "pos": (B,)}``: the new token and
                its absolute position.

        Returns:
            ``(logits (B, 1, vocab), new_caches)``; each block's new cache
            is ``(kc, vc, k, v)`` for a caller that appends.
        """
        x = embed(self.embed, batch["tokens"], self.adtype)
        positions = batch["pos"][:, None]
        h, new_caches = self._backbone(x, positions, caches=caches, mode="decode")
        return self._logits(h), new_caches

    # ----------------------------------------------------------------- caches

    def init_cache(self, batch: int, seq: int, dtype: Optional[torch.dtype] = None):
        """Zeroed caches of the ``prefill`` layout on the model's device."""
        dtype = dtype or self.adtype
        stack: list = []
        for _ in range(self.cfg.n_periods):
            stack.append({f"l{i}": init_block_cache(self.cfg, s, batch, seq, dtype,
                                                    self.device)
                          for i, s in enumerate(self.specs)})
        caches: Dict[str, Any] = {"stack": stack}
        return caches


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of ``logsumexp(logits) - logits[label]`` in float32."""
    lf = logits.to(torch.float32)
    ll = lf.gather(-1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(lf, dim=-1) - ll).mean()
