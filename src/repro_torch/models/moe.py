"""Mixture-of-Experts: shared plus routed top-k with capacity-based dispatch.

The port's counterpart of the JAX package's ``models/moe.py`` on one
device (its ``mesh is None`` branch).  Dispatch is GShard/Switch-style:
each (token, slot) gets its position in its expert from a cumulative sum
(slot-major, then token order), the kept ones are scattered into an
``(E * cap, d)`` buffer, the experts run one batched SwiGLU, and each
token gathers its slots back weighted by its gates.  A slot past its
expert's capacity is dropped: it goes to row ``E * cap`` of a buffer one
row longer, which is thrown away, as the reference's ``mode="drop"``
scatter discards it.  Each kept row receives exactly one token, so the
buffer is the reference's exactly, on the card too, where ``index_add``
adds in no fixed order.  The expert SwiGLU is ``torch.bmm``, as the
reference computes it in XLA, outside any Pallas kernel.

The distributed forms, expert-ff sharding under ``shard_map`` and expert
parallelism over all-to-all (the reference's ``moe.py:127-164`` and
``_moe_ep``), wait for ROADMAP A.9b.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional

import torch
from torch import nn

from .layers import Params, SwiGLU, dense_init, swiglu

__all__ = ["MoE", "moe_init", "moe_apply", "route", "dispatch", "record_routing"]

# The expert ids of each MoE call while ``record_routing`` is active.
_RECORD: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def record_routing() -> Iterator[List[torch.Tensor]]:
    """Collect the ``(T, k)`` expert ids of every MoE call in the block,
    in call order (one per MoE layer of a forward pass).

    Example:
        >>> with record_routing() as ids:
        ...     pass
        >>> ids
        []
    """
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = outer


class MoE(Params):
    """One MoE FFN's parameters: ``router`` (d, E) in float32, the experts'
    ``w1``, ``w3`` (E, d, expert_ff) and ``w2`` (E, expert_ff, d), and the
    shared experts' SwiGLU ``shared`` where ``n_shared > 0``."""

    def __init__(self, cfg, dtype, device):
        mc, d = cfg.moe, cfg.d_model
        super().__init__({"router": (d, mc.n_experts), "w1": (mc.n_experts, d, mc.expert_ff),
                          "w3": (mc.n_experts, d, mc.expert_ff),
                          "w2": (mc.n_experts, mc.expert_ff, d)},
                         dtype, device, float32=("router",))
        if mc.n_shared:
            self.shared = SwiGLU(d, mc.shared_ff or mc.n_shared * mc.expert_ff, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        """The router at scale ``d ** -0.5``, then w1, w3, w2 (fan-in
        truncated normals) and the shared SwiGLU."""
        dense_init(self["router"].shape, generator, scale=self["router"].shape[0]**-0.5,
                   out=self["router"].data)
        for name in ("w1", "w3", "w2"):
            dense_init(self[name].shape, generator, out=self[name].data)
        if "shared" in self._modules:
            self["shared"].init(generator)


def moe_init(generator: torch.Generator, cfg, dtype=torch.float32) -> MoE:
    """MoE parameters on the generator's device, initialised."""
    p = MoE(cfg, dtype, generator.device)
    p.init(generator)
    return p


def route(logits: torch.Tensor, mc):
    """``(T, E)`` router logits -> ``(gates (T, k), idx (T, k), probs (T, E))``.

    ``idx`` is in descending order of score, as ``jax.lax.top_k``'s, since
    the dispatch's priority reads the slots in order.  The softmax router
    takes the top-k probabilities; the sigmoid router (DeepSeek-V3) the
    top-k sigmoid scores, its probabilities the scores normalised.  The
    gates are renormalised over the k slots, with ``1e-9`` in the sums.
    """
    if mc.router == "sigmoid":
        scores = torch.sigmoid(logits)
        gates, idx = torch.topk(scores, mc.top_k, dim=-1, sorted=True)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, mc.top_k, dim=-1, sorted=True)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return gates, idx, probs


def capacity(t: int, mc) -> int:
    """Slots per expert for ``t`` tokens: ``max(ceil(t k / E cf), 4)``."""
    return max(int(math.ceil(t * mc.top_k / mc.n_experts * mc.capacity_factor)), 4)


def dispatch(idx: torch.Tensor, mc):
    """Where each (token, slot) goes.

    Args:
        idx: ``(T, k)`` expert ids from ``route``.
        mc: The ``MoECfg``.

    Returns:
        ``(pos, keep, slot, cap)``: ``pos`` (T, k) the position in its
        expert, slot-major then token order; ``keep = pos < cap``;
        ``slot = idx * cap + pos`` where kept, else ``E * cap``.
    """
    t, k = idx.shape
    e = mc.n_experts
    cap = capacity(t, mc)
    onehot = nn.functional.one_hot(idx, e)  # (T, k, E)
    pos_flat = onehot.transpose(0, 1).reshape(k * t, e).cumsum(0) - 1
    pos = pos_flat.reshape(k, t, e).gather(2, idx.T[..., None])[..., 0].T
    keep = pos < cap
    slot = torch.where(keep, idx * cap + pos, torch.full_like(pos, e * cap))
    return pos, keep, slot, cap


def _dispatch_compute_combine(x2, gates, idx, probs, p, mc):
    """The MoE core on ``x2`` (T, d); returns ``(out (T, d), aux)``."""
    t, d = x2.shape
    e, k = mc.n_experts, mc.top_k
    dt = x2.dtype
    _, keep, slot, cap = dispatch(idx, mc)
    flat = slot.reshape(-1)
    xk = x2[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = x2.new_zeros((e * cap + 1, d)).index_add(0, flat, xk)[:-1].reshape(e, cap, d)
    h = torch.bmm(buf, p["w1"].to(dt))
    u = torch.bmm(buf, p["w3"].to(dt))
    y = torch.bmm(nn.functional.silu(h) * u, p["w2"].to(dt)).reshape(e * cap, d)
    out_k = y.index_select(0, flat.clamp(max=e * cap - 1)).reshape(t, k, d)
    out = (out_k * (gates * keep).to(dt)[..., None]).sum(1)
    # the Switch balance loss: E * sum_e f_e * p_e
    frac_tokens = (nn.functional.one_hot(idx, e).to(torch.float32)
                   * keep[..., None]).sum(1).mean(0)
    aux = e * torch.sum(frac_tokens * probs.mean(0))
    return out, aux


def moe_apply(p, cfg, x: torch.Tensor):
    """x: (B, S, d) -> ``(out (B, S, d), aux)``, ``aux`` the balance loss
    times ``aux_loss_weight`` (float32).  The router runs in float32;
    capacity counts all B x S tokens of the call."""
    mc = cfg.moe
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    gates, idx, probs = route(x2.to(torch.float32) @ p["router"], mc)
    if _RECORD is not None:
        _RECORD.append(idx.detach())
    out, aux = _dispatch_compute_combine(x2, gates, idx, probs, p, mc)
    out = out.reshape(b, s, d)
    if mc.n_shared:
        out = out + swiglu(p["shared"], x)
    return out, aux * mc.aux_loss_weight
