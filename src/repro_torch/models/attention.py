"""Attention of the dense decoder: the chunked executor with the paper's
folded simplex schedule, the prefill dispatch, decode, and the GQA layer.

Causal attention's ``(q_tile, kv_tile)`` iteration space is a standard
2-simplex.  ``chunked_causal_attention`` is the plain-torch executor
(the reference's ``attention_impl="chunked"``): the bounding box
(``'bb'``) walks all ``nq x nq`` tiles and masks, the folded schedule
walks ``nq/2`` pairs of ``nq+1`` tiles.  ``simplex_attention`` sends
prefill to the flash kernel (``kernels/flash_attention.py``) when a tile
maps the shape.  ``full_attention`` is the bidirectional attention of
the encoder and of cross attention, plain torch as in the reference
(where it reaches no Pallas kernel).  ``sharded_causal_attention`` is the
decoder's causal attention with the reference's mesh forms: on a mesh
each rank attends over its own rows, and with tensor parallelism over
its slice of the heads, gathered over ``'model'``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..autotune.tuner import choose_attn_impl
from ..kernels.flash_attention import flash_attention
from ..kernels.policy import resolve_device
from .layers import Params, dense_init, mrope, rope

NEG_INF = -1e30

__all__ = [
    "chunked_causal_attention",
    "full_attention",
    "simplex_attention",
    "sharded_causal_attention",
    "decode_attention",
    "Attention",
    "attn_init",
    "attn_apply",
    "init_kv_cache",
]


def _best_chunk(s: int, chunk: int) -> int:
    """Largest divisor of s that is <= chunk."""
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    return chunk


def _gqa_scores(qg: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """qg: (B, Hkv, G, ..., bq, D), kb: (B, Hkv, ..., bk, D) -> f32 scores."""
    return torch.einsum("bhg...qd,bh...kd->bhg...qk", qg.float(), kb.float())


def _gqa_out(pr: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhg...qk,bh...kd->bhg...qd", pr.to(vb.dtype).float(), vb.float())


def chunked_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    chunk: int = 512,
    schedule: str = "folded",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal self-attention, GQA aware, O(S * chunk) live memory.

    q: (B, Hq, S, D); k, v: (B, Hkv, S, D).  schedule:
      'folded' — simplex walk, ~S^2/2 block FLOPs (the paper's map)
      'bb'     — bounding box, S^2 block FLOPs + mask (baseline)
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    dv = v.shape[-1]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    chunk = _best_chunk(s, chunk)
    nq = s // chunk
    if schedule == "folded" and (nq < 2 or nq % 2):
        schedule = "bb"
    dev = q.device
    qt = (q.reshape(b, hkv, g, nq, chunk, d).float() * scale).to(q.dtype)
    kt = k.reshape(b, hkv, nq, chunk, d)
    vt = v.reshape(b, hkv, nq, chunk, dv)
    row = torch.arange(chunk, device=dev)[:, None]
    col = torch.arange(chunk, device=dev)[None, :]

    if schedule == "bb":
        # every kv tile touches ALL q tiles (masked): the bounding box.
        m = torch.full((b, hkv, g, nq, chunk), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, nq, chunk), device=dev)
        acc = torch.zeros((b, hkv, g, nq, chunk, dv), device=dev)
        qtile = torch.arange(nq, device=dev)[:, None, None]
        for j in range(nq):
            sc = _gqa_scores(qt, kt[:, :, j])  # (B,Hkv,G,nq,bq,bk)
            causal = (qtile * chunk + row[None]) >= (j * chunk + col[None])
            sc = torch.where(causal, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(sc - m_new[..., None])
            l = l * alpha + pr.sum(-1)
            acc = acc * alpha[..., None] + _gqa_out(pr, vt[:, :, j])
            m = m_new
        out = acc / torch.where(l == 0, 1.0, l)[..., None]
        return out.reshape(b, hq, s, dv).to(q.dtype)

    # ---- folded simplex schedule: pair p serves q tiles p and nq-1-p ----
    P = nq // 2
    p_idx = torch.arange(P, device=dev)
    m = torch.full((b, hkv, g, P, chunk), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, P, chunk), device=dev)
    acc = torch.zeros((b, hkv, g, P, chunk, dv), device=dev)
    out = torch.zeros((b, hkv, g, nq, chunk, dv), device=dev)
    upper = col > row
    for j in range(nq + 1):
        second = j > p_idx
        qsel = torch.where(second, nq - 1 - p_idx, p_idx)
        ksel = torch.where(second, j - p_idx - 1, torch.full_like(p_idx, j))
        start = ((j == 0) | (j == p_idx + 1))[:, None]
        qb = qt.index_select(3, qsel)  # (B,Hkv,G,P,bq,D)
        kb = kt.index_select(2, ksel)  # (B,Hkv,P,bk,D)
        vb = vt.index_select(2, ksel)
        m = torch.where(start, NEG_INF, m)
        l = torch.where(start, 0.0, l)
        acc = torch.where(start[..., None], 0.0, acc)
        sc = _gqa_scores(qb, kb)  # (B,Hkv,G,P,bq,bk)
        mask = (qsel == ksel)[:, None, None] & upper
        sc = torch.where(mask, NEG_INF, sc)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(sc - m_new[..., None])
        l = l * alpha + pr.sum(-1)
        acc = acc * alpha[..., None] + _gqa_out(pr, vb)
        m = m_new
        for p in range(P):
            if j in (p, nq):  # flush the finished q tile of pair p (qsel[p], on the host)
                out[:, :, :, p if j == p else nq - 1 - p] = acc[:, :, :, p] / torch.where(
                    l[:, :, :, p] == 0, 1.0, l[:, :, :, p])[..., None]
    return out.reshape(b, hq, s, dv).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, chunk: int = 512,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Bidirectional (encoder or cross) attention, GQA aware, chunked over
    the keys with an online softmax.

    q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv).  Returns
    (B, Hq, Sq, Dv) in q's dtype.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    chunk = _best_chunk(sk, chunk)
    nk = sk // chunk
    qg = (q.float() * scale).to(q.dtype).reshape(b, hkv, g, sq, d)
    kt = k.reshape(b, hkv, nk, chunk, d)
    vt = v.reshape(b, hkv, nk, chunk, dv)
    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), device=q.device)
    for j in range(nk):
        sc = _gqa_scores(qg, kt[:, :, j])  # (B,Hkv,G,sq,bk)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(sc - m_new[..., None])
        l = l * alpha + pr.sum(-1)
        acc = acc * alpha[..., None] + _gqa_out(pr, vt[:, :, j])
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def simplex_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str = "auto",
    chunk: int = 512,
    schedule: str = "folded",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention through the prefill dispatch (DESIGN.md §8).

    Picks between the folded-simplex flash kernel and the chunked
    executor through ``autotune.choose_attn_impl`` on the tensors'
    device.  Structural guards send the chunked path regardless of
    ``impl``: ``v_head_dim != qk head dim`` (the flash kernel takes one
    head dim) and ragged GQA groups.

    Args:
        q: Queries (B, Hq, S, D).
        k: Keys (B, Hkv, S, D).
        v: Values (B, Hkv, S, Dv).
        impl: 'auto' | 'flash' | 'chunked' | 'flash-folded' | 'flash-bb'
            (any forced flash still takes the chunked path when no tile
            maps the shape).
        chunk: Chunk size for the chunked path.
        schedule: 'folded' | 'bb' for the chunked path.
        scale: Score scale; None = D**-0.5.

    Returns:
        Attention output, (B, Hq, S, Dv), in q's dtype.
    """
    if impl not in ("auto", "flash", "chunked", "flash-folded", "flash-bb"):
        raise ValueError(
            "impl must be 'auto', 'flash', 'chunked', 'flash-folded' or "
            f"'flash-bb'; got {impl!r}"
        )
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if impl != "chunked" and v.shape[-1] == d and hkv > 0 and hq % hkv == 0:
        dec = choose_attn_impl(s, hq, d, q.device, q.dtype)
        if dec.block_q > 0 and (dec.impl == "flash" or impl != "auto"):
            if "-" in impl:
                kind = impl.split("-", 1)[1]
            else:
                kind = dec.kind if dec.kind in ("folded", "bb") else "folded"
            return flash_attention(q, k, v, kind=kind, block_q=dec.block_q,
                                   block_kv=dec.block_q, scale=scale, device=q.device)
    return chunked_causal_attention(q, k, v, chunk=chunk, schedule=schedule, scale=scale)


def sharded_causal_attention(q, k, v, cfg, mesh=None) -> torch.Tensor:
    """The decoder's causal attention, with the reference's three branches.

    Every branch attends through ``simplex_attention`` with the config's
    executor knobs, so on the card prefill launches the flash kernel on
    each rank.  (The reference keeps the chunked executor inside
    ``shard_map`` because a Pallas call under GSPMD is outside its
    dispatch contract; a rank here holds plain local tensors.)

    * No mesh (or no ``'model'`` axis): one device.
    * ``cfg.tp_size <= 1``: the batch is split over every axis, so the
      rank's rows are its own and attention is local.  Where the batch
      does not divide, every rank holds all rows and attends over them, as
      the reference falls back to plain attention.
    * Tensor parallel: the rank takes its ``Hq / |model|`` heads, and the
      KV heads they read (``max(hq_loc // group, 1)`` from ``kv_start =
      (m * hq_loc) // group``), and the heads are gathered over
      ``'model'`` (``collectives.enter_tp`` / ``exit_gather``, so the
      backward is the single-device one).  Where the heads do not split
      into whole GQA groups, it attends over every head, as the reference
      falls back.

    Args:
        q: ``(B, Hq, S, D)``, this rank's rows, replicated over ``'model'``.
        k: ``(B, Hkv, S, D)``.
        v: ``(B, Hkv, S, Dv)``.
        cfg: The config: ``attention_impl``, ``attention_chunk``,
            ``attention_schedule``, ``tp_size``.
        mesh: A ``DeviceMesh`` with named axes, or None.

    Returns:
        ``(B, Hq, S, Dv)`` in q's dtype, replicated over ``'model'``.
    """
    def attend(ql, kl, vl):
        return simplex_attention(ql, kl, vl, impl=cfg.attention_impl,
                                 chunk=cfg.attention_chunk, schedule=cfg.attention_schedule)

    if mesh is None or "model" not in mesh.mesh_dim_names or cfg.tp_size <= 1:
        return attend(q, k, v)
    from ..distributed import collectives as C

    hq, hkv = q.shape[1], k.shape[1]
    group = hq // hkv
    msize = C.axis_sizes(mesh)["model"]
    hq_loc = hq // msize if hq % msize == 0 else 0
    if not (hq_loc > 0 and (hq_loc % group == 0 or group % hq_loc == 0)):
        return attend(q, k, v)
    m = mesh.get_local_rank("model")
    kv_start, kv_needed = (m * hq_loc) // group, max(hq_loc // group, 1)
    ql = C.enter_tp(q, mesh).narrow(1, m * hq_loc, hq_loc)
    kl = C.enter_tp(k, mesh).narrow(1, kv_start, kv_needed)
    vl = C.enter_tp(v, mesh).narrow(1, kv_start, kv_needed)
    o = attend(ql.contiguous(), kl.contiguous(), vl.contiguous())
    return C.exit_gather(o, mesh, dim=1)


def decode_attention(q, k_cache, v_cache, k_new, v_new, *, scale=None) -> torch.Tensor:
    """One-token attention against a full cache plus the new token.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D); k/v_new: (B, Hkv, 1, D).
    """
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    qg = (q.float() * scale).to(q.dtype).reshape(b, hkv, g, 1, d)
    sc_c = _gqa_scores(qg, k_cache)  # (B,Hkv,G,1,S)
    sc_n = _gqa_scores(qg, k_new)  # (B,Hkv,G,1,1)
    m = torch.maximum(sc_c.amax(-1), sc_n.amax(-1))[..., None]
    pc = torch.exp(sc_c - m)
    pn = torch.exp(sc_n - m)
    l = pc.sum(-1, keepdim=True) + pn.sum(-1, keepdim=True)
    out = (_gqa_out(pc, v_cache) + _gqa_out(pn, v_new)) / l
    return out.reshape(b, hq, 1, d).to(q.dtype)


class Attention(Params):
    """GQA projections: wq (D, Hq*hd), wk/wv (D, Hkv*hd), wo (Hq*hd, D)."""

    def __init__(self, cfg, dtype, device):
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        super().__init__({"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
                          "wo": (hq * hd, d)}, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        """Fan-in truncated normals, in the order wq, wk, wv, wo."""
        for name in ("wq", "wk", "wv", "wo"):
            dense_init(self[name].shape, generator, out=self[name].data)


def attn_init(generator: torch.Generator, cfg, dtype=torch.float32) -> Attention:
    """GQA projection parameters on the generator's device, initialised."""
    p = Attention(cfg, dtype, generator.device)
    p.init(generator)
    return p


def attn_apply(
    p,
    cfg,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mode: str = "train",
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    bidirectional: bool = False,
    positions3: Optional[torch.Tensor] = None,
    mesh=None,
):
    """Returns ``(out, new_cache)``.  Modes:
    train/prefill — full-sequence causal attention, or bidirectional with
    ``bidirectional`` (prefill also returns the ``(k, v)`` cache); decode
    — x is (B, 1, D) attending to ``cache`` plus itself, and the new cache
    is ``(kc, vc, k, v)`` for the caller to append.

    ``cross_kv`` attends to the given encoder ``(k, v)`` instead
    (bidirectional, no RoPE, no cache, in every mode).  With
    ``cfg.mrope_sections`` and ``positions3`` (B, S, 3), q and k take
    M-RoPE instead of RoPE.  ``mesh`` goes to the causal attention
    (``sharded_causal_attention``).
    """
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(b, s, hq, hd).transpose(1, 2)
    if cross_kv is None:
        k = (x @ p["wk"].to(dt)).reshape(b, s, hkv, hd).transpose(1, 2)
        v = (x @ p["wv"].to(dt)).reshape(b, s, hkv, hd).transpose(1, 2)
        if cfg.mrope_sections is not None and positions3 is not None:
            q = mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
            k = mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta)
        else:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
    else:
        k, v = cross_kv
    new_cache = None
    if mode == "decode" and cross_kv is None:
        kc, vc = cache[0], cache[1]
        o = decode_attention(q, kc, vc, k, v)
        new_cache = (kc, vc, k, v)
    elif bidirectional or cross_kv is not None:
        o = full_attention(q, k, v, chunk=cfg.attention_chunk)
        if mode == "prefill" and cross_kv is None:
            new_cache = (k, v)
    else:
        o = sharded_causal_attention(q.contiguous(), k.contiguous(), v.contiguous(), cfg,
                                     mesh)
        if mode == "prefill":
            new_cache = (k, v)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return o @ p["wo"].to(dt), new_cache


def init_kv_cache(cfg, batch: int, seq: int, dtype, device=None):
    """Zeroed decode K/V cache pair, each (batch, Hkv, seq, hd), on
    ``device`` (None means the card)."""
    device = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, seq, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
