"""Mamba-1 selective SSM mixer (Jamba's sequence mixer).

The port's counterpart of the JAX package's ``models/mamba.py``.  The
state update is the diagonal first-order recurrence ``h_t = decay_t *
h_{t-1} + u_t`` over ``(B, d_inner, d_state)``, read out as ``y_t = h_t .
C_t``.  The reference materialises ``decay`` and ``u`` for the whole
sequence, ``(B, S, d_inner, d_state)`` in float32, and runs
``jax.lax.associative_scan``; at jamba's full width and 4 x 2048 tokens
each of them is 4 GiB.  The port scans in chunks of ``SCAN_CHUNK``
tokens instead: each chunk's ``decay`` and ``u`` are made, the recurrence
steps through the chunk in order and the read-out sums inside it, so at
most one chunk's worth is live.  It rounds differently from the tree of
the associative scan, within float32 rounding.  The scan is no Pallas
kernel in the reference, so it is torch ops here.  Decode is the O(1)
step on the carried ``(ssm state (B, d_inner, d_state), conv tail (B,
d_conv - 1, d_inner))``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.policy import resolve_device
from .layers import Params, dense_init

__all__ = ["Mamba", "mamba_init", "mamba_apply", "init_mamba_cache", "SCAN_CHUNK"]

# Tokens per chunk of the prefill/train scan.
SCAN_CHUNK = 128

# dt_bias, a_log and d_skip stay float32 whatever the parameters' dtype.
_FLOAT32 = ("dt_bias", "a_log", "d_skip")


def _dims(cfg):
    mc = cfg.mamba
    return mc, mc.expand * cfg.d_model, mc.dt_rank or math.ceil(cfg.d_model / 16)


class Mamba(Params):
    """Mamba parameters: ``in_proj`` (d, 2 d_inner), the depthwise causal
    conv ``conv_w`` (d_conv, d_inner) and ``conv_b``, ``x_proj`` (d_inner,
    dt_rank + 2 d_state), ``dt_proj`` (dt_rank, d_inner), the float32
    ``dt_bias``, ``a_log`` (d_inner, d_state) and ``d_skip``, and
    ``out_proj`` (d_inner, d)."""

    def __init__(self, cfg, dtype, device):
        mc, di, dtr = _dims(cfg)
        d = cfg.d_model
        super().__init__({
            "in_proj": (d, 2 * di), "conv_w": (mc.d_conv, di), "conv_b": (di,),
            "x_proj": (di, dtr + 2 * mc.d_state), "dt_proj": (dtr, di), "dt_bias": (di,),
            "a_log": (di, mc.d_state), "d_skip": (di,), "out_proj": (di, d),
        }, dtype, device, float32=_FLOAT32)

    def init(self, generator: torch.Generator) -> None:
        """The reference's init: fan-in truncated normals, ``conv_w`` at
        scale ``d_conv ** -0.5``, ``conv_b`` zeros, ``dt_bias`` the inverse
        softplus of a step in [0.001, 0.1], ``a_log = log(1..d_state)``
        (S4D-real) and ``d_skip`` ones."""
        d_state, d_conv = self["a_log"].shape[1], self["conv_w"].shape[0]
        dense_init(self["in_proj"].shape, generator, out=self["in_proj"].data)
        dense_init(self["conv_w"].shape, generator, scale=d_conv**-0.5,
                   out=self["conv_w"].data)
        for name in ("x_proj", "dt_proj", "out_proj"):
            dense_init(self[name].shape, generator, out=self[name].data)
        with torch.no_grad():
            self["conv_b"].zero_()
            u = torch.rand(self["dt_bias"].shape, generator=generator,
                           device=generator.device)
            step = torch.clamp(u * (0.1 - 0.001) + 0.001, min=0.0001)
            self["dt_bias"].copy_(torch.log(torch.exp(step) - 1.0))
            a = torch.arange(1, d_state + 1, dtype=torch.float32, device=generator.device)
            self["a_log"].copy_(torch.log(a)[None, :].expand_as(self["a_log"]))
            self["d_skip"].fill_(1.0)


def mamba_init(generator: torch.Generator, cfg, dtype=torch.float32) -> Mamba:
    """Mamba parameters on the generator's device, initialised."""
    p = Mamba(cfg, dtype, generator.device)
    p.init(generator)
    return p


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv1d over ``[tail; x]``.  x: (B, S, di); w: (K,
    di); ``tail`` (B, K-1, di), zeros when None.  Returns ``(y,
    new_tail)``."""
    k = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(k))
    return y + b.to(x.dtype), xp[:, -(k - 1):]


def _ssm_inputs(p, cfg, x_act):
    """x_act: (B, S, di) -> ``delta`` (B, S, di) float32, ``B`` and ``C``
    (B, S, d_state) in the activations' dtype."""
    mc, _, dtr = _dims(cfg)
    dt = x_act.dtype
    proj = x_act @ p["x_proj"].to(dt)
    dt_in, bmat, cmat = proj.split([dtr, mc.d_state, mc.d_state], dim=-1)
    delta = nn.functional.softplus((dt_in @ p["dt_proj"].to(dt)).to(torch.float32)
                                   + p["dt_bias"])
    return delta, bmat, cmat


def _decay_u(p, delta, x_act, bmat):
    """``decay = exp(delta a)`` and ``u = delta x B``, (B, S, di, d_state)
    in float32, with ``a = -exp(a_log)``."""
    a = -torch.exp(p["a_log"])
    decay = torch.exp(delta[..., None] * a)
    u = (delta * x_act.to(torch.float32))[..., None] * bmat.to(torch.float32)[:, :, None, :]
    return decay, u


def _scan(p, delta, x_act, bmat, cmat):
    """The recurrence over the whole sequence in chunks; returns ``(y (B,
    S, di) float32, h_last (B, di, d_state))``."""
    b, s, di = delta.shape
    h = delta.new_zeros((b, di, p["a_log"].shape[1]))
    ys = []
    for c0 in range(0, s, SCAN_CHUNK):
        c1 = min(c0 + SCAN_CHUNK, s)
        decay, u = _decay_u(p, delta[:, c0:c1], x_act[:, c0:c1], bmat[:, c0:c1])
        hs = []
        for t in range(c1 - c0):
            h = torch.addcmul(u[:, t], decay[:, t], h)
            hs.append(h)
        del decay, u
        hc = torch.stack(hs, dim=1)  # (B, L, di, N)
        ys.append((hc * cmat[:, c0:c1].to(torch.float32)[:, :, None, :]).sum(-1))
        del hc, hs
    return torch.cat(ys, dim=1), h


def mamba_apply(p, cfg, x: torch.Tensor, *,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                mode: str = "train"):
    """One Mamba mixer.  x: (B, S, d).

    Returns:
        ``(out, new_cache)``: after prefill ``(h_last, conv_tail)``, in
        decode (S = 1, against ``cache``) the stepped ``(h, conv_tail)``,
        None in train.
    """
    dt = x.dtype
    x_in, z = (x @ p["in_proj"].to(dt)).chunk(2, dim=-1)
    silu = nn.functional.silu

    if mode == "decode":
        ssm_state, conv_tail = cache[0], cache[1]
        xc, new_tail = _causal_conv(x_in, p["conv_w"], p["conv_b"], conv_tail)
        x_act = silu(xc)
        delta, bmat, cmat = _ssm_inputs(p, cfg, x_act)
        decay, u = _decay_u(p, delta, x_act, bmat)
        h = decay[:, 0] * ssm_state + u[:, 0]
        y = (h * cmat.to(torch.float32)[:, 0, None, :]).sum(-1)
        y = y + p["d_skip"] * x_act.to(torch.float32)[:, 0]
        out = (silu(z[:, 0]).to(torch.float32) * y).to(dt)[:, None] @ p["out_proj"].to(dt)
        return out, (h, new_tail)

    xc, new_tail = _causal_conv(x_in, p["conv_w"], p["conv_b"])
    x_act = silu(xc)
    delta, bmat, cmat = _ssm_inputs(p, cfg, x_act)
    y, h_last = _scan(p, delta, x_act, bmat, cmat)
    y = y + p["d_skip"] * x_act.to(torch.float32)
    out = (silu(z).to(torch.float32) * y).to(dt) @ p["out_proj"].to(dt)
    return out, ((h_last, new_tail) if mode == "prefill" else None)


def init_mamba_cache(cfg, batch: int, dtype, device=None):
    """Zeroed decode cache ``(ssm state (B, d_inner, d_state) float32, conv
    tail (B, d_conv - 1, d_inner))`` on ``device`` (None means the card)."""
    device = resolve_device(device)
    mc, di, _ = _dims(cfg)
    return (torch.zeros((batch, di, mc.d_state), dtype=torch.float32, device=device),
            torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype, device=device))
