"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), after
arXiv:2405.04517.

The port's counterpart of the JAX package's ``models/xlstm.py``.  The
mLSTM is a gated linear-attention cell: its state ``C_t = f_t C_{t-1} +
i_t k_t v_t^T`` has exponential gates kept in range by a running max
``m_t``.  Train and prefill run the chunkwise form: inside a chunk the
log weights ``D[t, s] = A_t - A_s + b_s`` live on the lower triangle
``s <= t`` (the 2-simplex of the intra-chunk interaction), and a loop
over the chunks carries ``(C, n, m)``.  Decode steps the same ``(C, n,
m)`` one token at a time.  The chunk-end update ``sum_s w_s k_s v_s^T``
is a product of ``(w k)^T`` and ``v``, never the ``(L, dh, dh)`` outer
products.  Neither form is a Pallas kernel in the reference, so both are
torch ops here.

The sLSTM keeps a scalar state per channel with exponential gating and a
normaliser, and a recurrent kernel per head; it is a loop over time, as
the reference's scan is, followed by a headwise group norm and a gated
FFN (tanh-form GELU).

Two "no state" values are the reference's: the chunkwise form starts
``m`` at ``-inf`` (and masks the triangle with ``-inf``), the decode
caches start it at ``-1e30``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.policy import resolve_device
from .layers import Params, dense_init
from .mamba import _causal_conv

__all__ = [
    "MLSTM",
    "SLSTM",
    "mlstm_init",
    "mlstm_apply",
    "mlstm_chunkwise",
    "mlstm_recurrent",
    "slstm_init",
    "slstm_apply",
    "init_mlstm_cache",
    "init_slstm_cache",
]

# The decode caches' running max before the first token.
M_START = -1e30

_silu = nn.functional.silu


def _mdims(cfg):
    xc = cfg.xlstm
    dp = int(cfg.d_model * xc.proj_factor_mlstm)
    return xc, dp, xc.n_heads, dp // xc.n_heads


def _sdims(cfg):
    xc = cfg.xlstm
    dff = int(cfg.d_model * xc.proj_factor_slstm)
    dff = ((dff + 63) // 64) * 64  # a multiple of 64, as the reference rounds it
    return xc, xc.n_heads, cfg.d_model // xc.n_heads, dff


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTM(Params):
    """mLSTM parameters: ``up`` (d, 2 dp), the causal conv ``conv_w`` (d_conv,
    dp) and ``conv_b``, ``wq``/``wk``/``wv`` (dp, dp), the float32 gate
    projections ``wi``/``wf`` (dp, H), ``down`` (dp, d) and ``skip_scale``
    (dp,)."""

    def __init__(self, cfg, dtype, device):
        xc, dp, h, _ = _mdims(cfg)
        d = cfg.d_model
        super().__init__({
            "up": (d, 2 * dp), "conv_w": (xc.d_conv, dp), "conv_b": (dp,), "wq": (dp, dp),
            "wk": (dp, dp), "wv": (dp, dp), "wi": (dp, h), "wf": (dp, h), "down": (dp, d),
            "skip_scale": (dp,),
        }, dtype, device, float32=("wi", "wf"))

    def init(self, generator: torch.Generator) -> None:
        """The reference's init: fan-in truncated normals, ``conv_w`` at
        scale ``d_conv ** -0.5``, the gates at 0.02, ``conv_b`` zeros and
        ``skip_scale`` ones."""
        d_conv = self["conv_w"].shape[0]
        dense_init(self["up"].shape, generator, out=self["up"].data)
        dense_init(self["conv_w"].shape, generator, scale=d_conv**-0.5,
                   out=self["conv_w"].data)
        for name in ("wq", "wk", "wv"):
            dense_init(self[name].shape, generator, out=self[name].data)
        for name in ("wi", "wf"):
            dense_init(self[name].shape, generator, scale=0.02, out=self[name].data)
        dense_init(self["down"].shape, generator, out=self["down"].data)
        with torch.no_grad():
            self["conv_b"].zero_()
            self["skip_scale"].fill_(1.0)


def mlstm_init(generator: torch.Generator, cfg, dtype=torch.float32) -> MLSTM:
    """mLSTM parameters on the generator's device, initialised."""
    p = MLSTM(cfg, dtype, generator.device)
    p.init(generator)
    return p


def _qkvgates(p, cfg, x_in, conv_tail=None):
    """q, k, v (B, H, S, dh), the float32 gate pre-activations ``ig``,
    ``fg`` (B, H, S), and the conv's new tail."""
    _, _, h, dh = _mdims(cfg)
    xc_out, new_tail = _causal_conv(x_in, p["conv_w"], p["conv_b"], conv_tail)
    x_conv = _silu(xc_out)
    dt = x_in.dtype
    b, s, _ = x_in.shape

    def heads(t):
        return t.reshape(b, s, h, dh).transpose(1, 2)

    q = heads(x_conv @ p["wq"].to(dt))
    k = heads(x_conv @ p["wk"].to(dt)) * (dh**-0.5)
    v = heads(x_in @ p["wv"].to(dt))
    xf = x_conv.to(torch.float32)
    ig = (xf @ p["wi"]).transpose(1, 2)
    fg = (xf @ p["wf"]).transpose(1, 2)
    return q, k, v, ig, fg, new_tail


def _mlstm_step(c, n, m, q, k, v, ig, fg):
    """One recurrent step.  c: (B, H, dh, dh), n: (B, H, dh), m: (B, H);
    q, k, v: (B, H, dh); ig, fg: (B, H)."""
    logf = nn.functional.logsigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    f_s = torch.exp(logf + m - m_new)[..., None]
    i_s = torch.exp(ig - m_new)[..., None]
    kf, vf, qf = k.to(torch.float32), v.to(torch.float32), q.to(torch.float32)
    c_new = f_s[..., None] * c + i_s[..., None] * kf[..., :, None] * vf[..., None, :]
    n_new = f_s * n + i_s * kf
    num = (qf[..., None, :] @ c_new)[..., 0, :]
    den = torch.maximum((n_new * qf).sum(-1).abs(), torch.exp(-m_new))[..., None]
    return c_new, n_new, m_new, num / den


def mlstm_recurrent(p, cfg, x_in: torch.Tensor, state):
    """The step-by-step form (decode).  x_in: (B, S, dp); ``state`` is
    ``(C, n, m, conv_tail)``.  Returns ``(outs (B, H, S, dh) float32,
    (C, n, m, new_tail))``."""
    c, n, m, conv_tail = state
    q, k, v, ig, fg, new_tail = _qkvgates(p, cfg, x_in, conv_tail)
    outs = []
    for t in range(x_in.shape[1]):
        c, n, m, out = _mlstm_step(c, n, m, q[:, :, t], k[:, :, t], v[:, :, t],
                                   ig[:, :, t], fg[:, :, t])
        outs.append(out)
    return torch.stack(outs, dim=2), (c, n, m, new_tail)


def mlstm_chunkwise(p, cfg, x_in: torch.Tensor):
    """The chunkwise-parallel form (train and prefill).  x_in: (B, S, dp),
    S a multiple of ``min(cfg.xlstm.chunk, S)``.  Returns ``(outs (B, H,
    S, dh) float32, (C, n, m))``, the state after the last token."""
    xc, _, h, dh = _mdims(cfg)
    b, s, _ = x_in.shape
    L = min(xc.chunk, s)
    assert s % L == 0, (s, L)
    nc = s // L
    q, k, v, ig, fg, _ = _qkvgates(p, cfg, x_in)
    qc = q.reshape(b, h, nc, L, dh)
    kc = k.reshape(b, h, nc, L, dh)
    vc = v.reshape(b, h, nc, L, dh)
    igc = ig.reshape(b, h, nc, L)
    A = torch.cumsum(nn.functional.logsigmoid(fg).reshape(b, h, nc, L), dim=-1)
    row = torch.arange(L, device=x_in.device)[:, None]
    tri = torch.arange(L, device=x_in.device)[None, :] <= row  # the 2-simplex
    c = x_in.new_zeros((b, h, dh, dh), dtype=torch.float32)
    n = x_in.new_zeros((b, h, dh), dtype=torch.float32)
    m = torch.full((b, h), -torch.inf, dtype=torch.float32, device=x_in.device)
    outs = []
    for ci in range(nc):
        a = A[:, :, ci]  # (B, H, L)
        bgate = igc[:, :, ci]
        # intra-chunk log weights D[t, s] = a_t - a_s + b_s for s <= t
        dmat = a[..., :, None] - a[..., None, :] + bgate[..., None, :]
        dmat = torch.where(tri, dmat, -torch.inf)
        m_state = m[..., None] + a  # (B, H, L)
        m_t = torch.maximum(dmat.amax(-1), m_state)
        w = torch.exp(dmat - m_t[..., None])  # (B, H, L, L)
        qf = qc[:, :, ci].to(torch.float32)
        kf = kc[:, :, ci].to(torch.float32)
        vf = vc[:, :, ci].to(torch.float32)
        scores = (qf @ kf.transpose(-1, -2)) * w
        decay = torch.exp(m_state - m_t)
        num = scores @ vf + decay[..., None] * (qf @ c)
        den_state = decay * (qf @ n[..., None])[..., 0]
        den = torch.maximum((scores.sum(-1) + den_state).abs(), torch.exp(-m_t))
        outs.append(num / den[..., None])  # (B, H, L, dh)
        # the state at the chunk's end
        a_tot = a[..., -1]  # (B, H)
        g = a_tot[..., None] - a + bgate  # decay from position s to the chunk end
        m_next = torch.maximum(m + a_tot, g.amax(-1))
        scale_c = torch.exp(m + a_tot - m_next)
        wk = torch.exp(g - m_next[..., None])[..., None] * kf  # (B, H, L, dh)
        c = scale_c[..., None, None] * c + wk.transpose(-1, -2) @ vf
        n = scale_c[..., None] * n + wk.sum(-2)
        m = m_next
    return torch.cat(outs, dim=2), (c, n, m)


def mlstm_apply(p, cfg, x: torch.Tensor, *, cache=None, mode: str = "train"):
    """The mLSTM block: up-projection, conv, q/k/v and gates, the cell, a
    learned skip and the z-gated down-projection (the caller adds the
    residual).  x: (B, S, d).

    Returns:
        ``(out, new_cache)``: after prefill ``(C, n, m, conv_tail)``, in
        decode (against ``cache``) the stepped state, None in train.
    """
    _, dp, _, _ = _mdims(cfg)
    b, s, _ = x.shape
    dt = x.dtype
    x_in, z = (x @ p["up"].to(dt)).chunk(2, dim=-1)
    if mode == "decode":
        outs, new_state = mlstm_recurrent(p, cfg, x_in, cache)
    else:
        outs, state = mlstm_chunkwise(p, cfg, x_in)
        new_state = None
        if mode == "prefill":
            _, tail = _causal_conv(x_in, p["conv_w"], p["conv_b"])
            new_state = state + (tail,)
    y = outs.transpose(1, 2).reshape(b, s, dp).to(dt)
    y = y + p["skip_scale"].to(dt) * x_in
    return (y * _silu(z)) @ p["down"].to(dt), new_state


def init_mlstm_cache(cfg, batch: int, dtype, device=None):
    """The zeroed decode cache ``(C (B, H, dh, dh), n (B, H, dh), m (B, H)
    at -1e30, all float32; conv tail (B, d_conv - 1, dp))`` on ``device``
    (None means the card)."""
    device = resolve_device(device)
    xc, dp, h, dh = _mdims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, h, dh, dh), **f32), torch.zeros((batch, h, dh), **f32),
            torch.full((batch, h), M_START, **f32),
            torch.zeros((batch, xc.d_conv - 1, dp), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(Params):
    """sLSTM parameters: the fused input projection ``w_in`` (d, 4 d) of
    (z, i, f, o), the per-head recurrent kernels ``r`` (4, H, dh, dh), the
    float32 ``bias`` (4, d), the group norm's ``w_gn`` (d,) and the gated
    FFN's ``up1``, ``up2`` (d, dff) and ``down`` (dff, d)."""

    def __init__(self, cfg, dtype, device):
        _, h, dh, dff = _sdims(cfg)
        d = cfg.d_model
        super().__init__({
            "w_in": (d, 4 * d), "r": (4, h, dh, dh), "bias": (4, d), "w_gn": (d,),
            "up1": (d, dff), "up2": (d, dff), "down": (dff, d),
        }, dtype, device, float32=("bias",))

    def init(self, generator: torch.Generator) -> None:
        """The reference's init: fan-in truncated normals, ``r`` at scale
        ``dh ** -0.5``, ``bias`` zeros and ``w_gn`` ones."""
        dh = self["r"].shape[-1]
        dense_init(self["w_in"].shape, generator, out=self["w_in"].data)
        dense_init(self["r"].shape, generator, scale=dh**-0.5, out=self["r"].data)
        for name in ("up1", "up2", "down"):
            dense_init(self[name].shape, generator, out=self[name].data)
        with torch.no_grad():
            self["bias"].zero_()
            self["w_gn"].fill_(1.0)


def slstm_init(generator: torch.Generator, cfg, dtype=torch.float32) -> SLSTM:
    """sLSTM parameters on the generator's device, initialised."""
    p = SLSTM(cfg, dtype, generator.device)
    p.init(generator)
    return p


def slstm_apply(p, cfg, x: torch.Tensor, *, cache=None, mode: str = "train"):
    """The sLSTM block: the recurrent scalar-memory cell over time, a
    headwise group norm and the gated FFN.  x: (B, S, d); ``cache`` is
    ``(c, n, h_prev, m)``, each (B, d), zeros (and ``m`` at -1e30) when
    None.

    Returns:
        ``(out, new_cache)``: the state after the last token in prefill
        and decode, None in train.
    """
    _, h, dh, _ = _sdims(cfg)
    b, s, d = x.shape
    dt = x.dtype
    zifo = (x @ p["w_in"].to(dt)).reshape(b, s, 4, d).permute(1, 2, 0, 3).to(torch.float32)
    if cache is None:
        cache = init_slstm_cache(cfg, b, dt, x.device)
    c, n, h_prev, m = cache
    r = p["r"].to(dt)
    bias = p["bias"][:, None, :]
    hs = []
    for t in range(s):
        rec = torch.einsum("bhi,ghij->gbhj", h_prev.reshape(b, h, dh).to(dt), r)
        pre = zifo[t] + rec.reshape(4, b, d).to(torch.float32) + bias
        zt = torch.tanh(pre[0])
        it = pre[1]
        logf = nn.functional.logsigmoid(pre[2])
        ot = torch.sigmoid(pre[3])
        m_new = torch.maximum(logf + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * zt
        n = f_s * n + i_s
        h_prev = (ot * c / torch.clamp(n, min=1.0)).to(dt)
        m = m_new
        hs.append(h_prev)
    hf = torch.stack(hs, dim=1).to(torch.float32).reshape(b, s, h, dh)
    hf = (hf - hf.mean(-1, keepdim=True)) * torch.rsqrt(
        hf.var(-1, unbiased=False, keepdim=True) + cfg.norm_eps)
    y = (hf.reshape(b, s, d) * p["w_gn"].to(torch.float32)).to(dt)
    u = y @ p["up1"].to(dt)
    g = y @ p["up2"].to(dt)
    out = (nn.functional.gelu(u, approximate="tanh") * g) @ p["down"].to(dt)
    return out, ((c, n, h_prev, m) if mode in ("prefill", "decode") else None)


def init_slstm_cache(cfg, batch: int, dtype, device=None):
    """The zeroed decode cache ``(c, n, h_prev, m)``, each (B, d): ``c``,
    ``n`` and ``m`` (at -1e30) float32, ``h_prev`` in ``dtype``, on
    ``device`` (None means the card)."""
    device = resolve_device(device)
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, d), **f32), torch.zeros((batch, d), **f32),
            torch.zeros((batch, d), dtype=dtype, device=device),
            torch.full((batch, d), M_START, **f32))
