"""Multi-head Latent Attention (DeepSeek-V3), with decode absorption.

The port's counterpart of the JAX package's ``models/mla.py``.
Train and prefill: Q through the low-rank path (``w_dq`` -> RMSNorm ->
``w_uq``), K and V expanded per head from the shared compressed latent
``c_kv`` (``kv_lora_rank``), plus one RoPE key shared by all heads.  The
qk head dim (nope + rope) differs from the v head dim, so
``simplex_attention``'s structural guard sends the expanded attention to
the chunked executor, as the reference's dispatch does.  Decode is the
absorbed form: ``w_uk`` folds into the query and ``w_uv`` applies after
attention over the latent, so the cache per token is
``kv_lora_rank + qk_rope_dim`` numbers whatever the head count.  As in
every decode of the port, the new token attends to the fixed prefill
cache plus itself.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.policy import resolve_device
from .attention import sharded_causal_attention
from .layers import Params, RMSNorm, dense_init, rmsnorm, rope

__all__ = ["MLA", "mla_init", "mla_apply", "init_mla_cache"]


class MLA(Params):
    """MLA parameters: the low-rank query path (``w_dq``, ``q_norm``,
    ``w_uq``), the shared latent (``w_dkv``, ``kv_norm``), the decoupled
    RoPE key ``w_kr``, the per-head expansions ``w_uk``, ``w_uv`` and the
    output ``wo``."""

    def __init__(self, cfg, dtype, device):
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        super().__init__({
            "w_dq": (d, m.q_lora_rank),
            "w_uq": (m.q_lora_rank, h * (m.qk_nope_dim + m.qk_rope_dim)),
            "w_dkv": (d, m.kv_lora_rank),
            "w_kr": (d, m.qk_rope_dim),
            "w_uk": (m.kv_lora_rank, h * m.qk_nope_dim),
            "w_uv": (m.kv_lora_rank, h * m.v_head_dim),
            "wo": (h * m.v_head_dim, d),
        }, dtype, device)
        self.q_norm = RMSNorm(m.q_lora_rank, dtype, device)
        self.kv_norm = RMSNorm(m.kv_lora_rank, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        """Fan-in truncated normals for the matrices, ones for the norms."""
        for name in ("w_dq", "w_uq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo"):
            dense_init(self[name].shape, generator, out=self[name].data)
        self.q_norm.init(generator)
        self.kv_norm.init(generator)


def mla_init(generator: torch.Generator, cfg, dtype=torch.float32) -> MLA:
    """MLA parameters on the generator's device, initialised."""
    p = MLA(cfg, dtype, generator.device)
    p.init(generator)
    return p


def _project_q(p, cfg, x, positions):
    """Low-rank query projection -> ``(q_nope, q_pe)``, both (B, H, S, *)."""
    m = cfg.mla
    b, s, _ = x.shape
    dt = x.dtype
    cq = rmsnorm(p["q_norm"], x @ p["w_dq"].to(dt), cfg.norm_eps)
    q = (cq @ p["w_uq"].to(dt)).reshape(b, s, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_pe = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_pe = rope(q_pe.transpose(1, 2), positions, cfg.rope_theta)
    return q_nope.transpose(1, 2), q_pe


def mla_apply(p, cfg, x: torch.Tensor, positions: torch.Tensor, *,
              cache: Optional[Tuple[torch.Tensor, ...]] = None, mode: str = "train",
              mesh=None):
    """One MLA mixer.

    Args:
        p: ``MLA`` parameters (or a mapping of the same names).
        cfg: The config; ``cfg.mla`` holds the ranks and head dims.
        x: ``(B, S, d_model)``.
        positions: ``(B, S)`` token positions for RoPE.
        cache: Decode only: the latent cache ``(c_kv (B, S, L), k_pe
            (B, S, R), ...)``; entries past the first two are ignored.
        mode: ``"train"`` / ``"prefill"`` (expanded attention) or
            ``"decode"`` (absorbed attention over the latent cache).
        mesh: A ``DeviceMesh`` for the expanded attention's mesh forms
            (``sharded_causal_attention``), or None.

    Returns:
        ``(out, new_cache)``: after prefill the latent pair ``(c_kv,
        k_pe)``; in decode ``(c_kv, k_pe, c_kv_new, k_pe_new)`` for a
        caller that appends; None in train.
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dt = x.dtype
    q_nope, q_pe = _project_q(p, cfg, x, positions)
    c_kv_new = rmsnorm(p["kv_norm"], x @ p["w_dkv"].to(dt), cfg.norm_eps)
    k_pe_new = rope((x @ p["w_kr"].to(dt))[:, None], positions, cfg.rope_theta)[:, 0]

    if mode != "decode":
        k_nope = (c_kv_new @ p["w_uk"].to(dt)).reshape(b, s, h, m.qk_nope_dim).transpose(1, 2)
        v = (c_kv_new @ p["w_uv"].to(dt)).reshape(b, s, h, m.v_head_dim).transpose(1, 2)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe_new[:, None].expand(b, h, s, m.qk_rope_dim)], dim=-1)
        o = sharded_causal_attention(q.contiguous(), k.contiguous(), v.contiguous(), cfg,
                                     mesh)
        out = o.transpose(1, 2).reshape(b, s, h * m.v_head_dim) @ p["wo"].to(dt)
        return out, ((c_kv_new, k_pe_new) if mode == "prefill" else None)

    # absorbed decode over the latent cache
    c_kv, k_pe = cache[0], cache[1]  # (B, S, L), (B, S, R)
    f32 = torch.float32
    w_uk = p["w_uk"].to(dt).reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_abs = torch.einsum("bhqn,lhn->bhql", q_nope, w_uk)  # (B, H, 1, L)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    qa, qp = q_abs.to(f32), q_pe.to(f32)
    sc = (torch.einsum("bhql,bsl->bhqs", qa, c_kv.to(f32))
          + torch.einsum("bhqr,bsr->bhqs", qp, k_pe.to(f32))) * scale
    sc_new = (torch.einsum("bhql,bl->bhq", qa, c_kv_new[:, 0].to(f32))
              + torch.einsum("bhqr,br->bhq", qp, k_pe_new[:, 0].to(f32)))[..., None] * scale
    mx = torch.maximum(sc.amax(-1, keepdim=True), sc_new)
    pc = torch.exp(sc - mx)
    pn = torch.exp(sc_new - mx)
    denom = pc.sum(-1, keepdim=True) + pn
    ctx = (torch.einsum("bhqs,bsl->bhql", pc.to(dt), c_kv)
           + pn.to(dt) * c_kv_new[:, None, 0:1]) / denom.to(dt)
    w_uv = p["w_uv"].to(dt).reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bhql,lhv->bhqv", ctx, w_uv)  # (B, H, 1, vd)
    out = o.transpose(1, 2).reshape(b, s, h * m.v_head_dim) @ p["wo"].to(dt)
    return out, (c_kv, k_pe, c_kv_new, k_pe_new)


def init_mla_cache(cfg, batch: int, seq: int, dtype, device=None):
    """Zeroed latent decode cache ``(c_kv (B, S, kv_lora_rank), k_pe (B, S,
    qk_rope_dim))`` on ``device`` (None means the card)."""
    device = resolve_device(device)
    m = cfg.mla
    return (torch.zeros((batch, seq, m.kv_lora_rank), dtype=dtype, device=device),
            torch.zeros((batch, seq, m.qk_rope_dim), dtype=dtype, device=device))
