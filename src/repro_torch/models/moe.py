"""Mixture-of-Experts: shared plus routed top-k with capacity-based dispatch.

The port's counterpart of the JAX package's ``models/moe.py``.  Dispatch
is GShard/Switch-style: each (token, slot) gets its position in its
expert from a cumulative sum (slot-major, then token order), the kept
ones are scattered into an ``(E * cap, d)`` buffer, the experts run one
batched SwiGLU, and each token gathers its slots back weighted by its
gates.  A slot past its expert's capacity is dropped: it goes to row
``E * cap`` of a buffer one row longer, which is thrown away, as the
reference's ``mode="drop"`` scatter discards it.  Each kept row receives
exactly one token, so the buffer is the reference's exactly, on the card
too, where ``index_add`` adds in no fixed order.  The expert SwiGLU is
``torch.bmm``, as the reference computes it in XLA, outside any Pallas
kernel.

On a mesh (``moe_apply(..., mesh)``) every rank routes its own rows, so
capacity is local to each data shard (the GShard "group" semantics), and
the balance loss is averaged over the data axes.  Two forms split the
experts' work over ``'model'``:

* tensor parallel (``impl="tp"``, the reference's ``moe.py:132-164``):
  each rank computes its ``expert_ff / |model|`` slice of every expert,
  and the partial outputs are all-reduced after combine;
* expert parallel (``impl="ep"``, ``_moe_ep``): each rank holds ``E /
  |model|`` whole experts; the dispatch buffers go to their experts' ranks
  and the results come back, two all-to-alls over ``'model'``.

``moe_form`` says which form a config takes on a mesh, and
``experts_split`` whether the forms cut the experts over ``'model'``.
Each form narrows whole expert weights to this rank's block, whose
gradient is then partial over ``'model'``, unless the MoE's ``blocks``
is set: then the weights it holds are this rank's block already (the
step bundle gathers them over the data axes only, as the reference's
``shard_map`` takes them), and their gradients are this rank's own.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional

import torch
from torch import nn

from .layers import Params, SwiGLU, dense_init, swiglu

__all__ = ["MoE", "moe_init", "moe_apply", "route", "dispatch", "record_routing", "moe_form",
           "experts_split"]

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
    shared experts' SwiGLU ``shared`` where ``n_shared > 0``.

    ``blocks``: the mesh forms take ``w1``, ``w3``, ``w2`` as this rank's
    block (TP: ``expert_ff / |model|`` columns of ``w1``, ``w3`` and rows
    of ``w2``; EP: ``E / |model|`` whole experts) instead of narrowing
    whole ones; a step bundle sets it on its own model while it binds
    them so."""

    blocks = False

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


def _one_hot(idx: torch.Tensor, e: int) -> torch.Tensor:
    """``one_hot(idx, e)`` (int64) as a comparison with ``arange(e)``:
    ``nn.functional.one_hot`` on the CPU reads ``idx``'s range on the host
    (``.item()``), which a captured decode may not do."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).long()


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
    onehot = _one_hot(idx, e)  # (T, k, E)
    pos_flat = onehot.transpose(0, 1).reshape(k * t, e).cumsum(0) - 1
    pos = pos_flat.reshape(k, t, e).gather(2, idx.T[..., None])[..., 0].T
    keep = pos < cap
    slot = torch.where(keep, idx * cap + pos, torch.full_like(pos, e * cap))
    return pos, keep, slot, cap


def _buffer(x2, slot, mc, cap):
    """The ``(E * cap, d)`` dispatch buffer: each kept (token, slot) in its
    row, the dropped ones in a last row that is cut off."""
    t, d = x2.shape
    k = slot.shape[1]
    xk = x2[:, None, :].expand(t, k, d).reshape(t * k, d)
    return x2.new_zeros((mc.n_experts * cap + 1, d)).index_add(0, slot.reshape(-1), xk)[:-1]


def _experts(buf, w1, w3, w2):
    """The batched expert SwiGLU on ``buf`` (E, C, d)."""
    dt = buf.dtype
    h = torch.bmm(buf, w1.to(dt))
    u = torch.bmm(buf, w3.to(dt))
    return torch.bmm(nn.functional.silu(h) * u, w2.to(dt))


def _combine(y, slot, gates, keep, t, k, mc, cap):
    """Each token's slots gathered from ``y`` (E * cap, d) and weighted."""
    out_k = y.index_select(0, slot.reshape(-1).clamp(max=mc.n_experts * cap - 1))
    return (out_k.reshape(t, k, -1) * (gates * keep).to(y.dtype)[..., None]).sum(1)


def _balance(idx, keep, probs, mc):
    """The Switch balance loss: ``E * sum_e f_e * p_e``."""
    e = mc.n_experts
    frac_tokens = (_one_hot(idx, e).to(torch.float32)
                   * keep[..., None]).sum(1).mean(0)
    return e * torch.sum(frac_tokens * probs.mean(0))


def _dispatch_compute_combine(x2, gates, idx, probs, p, mc, mesh=None):
    """The MoE core on ``x2`` (T, d); returns ``(out (T, d), aux)``.  With
    ``mesh`` it computes this rank's ``expert_ff`` slice (TP form) and
    all-reduces the partial outputs over ``'model'``."""
    t, _ = x2.shape
    _, keep, slot, cap = dispatch(idx, mc)
    w1, w3, w2 = p["w1"], p["w3"], p["w2"]
    if mesh is not None:
        from ..distributed import collectives as C

        if not p.blocks:
            f = mc.expert_ff // C.axis_sizes(mesh)["model"]
            lo = mesh.get_local_rank("model") * f
            w1, w3, w2 = w1.narrow(2, lo, f), w3.narrow(2, lo, f), w2.narrow(1, lo, f)
        x2, gates = C.enter_tp(x2, mesh), C.enter_tp(gates, mesh)
    buf = _buffer(x2, slot, mc, cap).reshape(mc.n_experts, cap, -1)
    y = _experts(buf, w1, w3, w2).reshape(mc.n_experts * cap, -1)
    out = _combine(y, slot, gates, keep, t, idx.shape[1], mc, cap)
    if mesh is not None:
        out = C.exit_reduce(out, mesh)
    return out, _balance(idx, keep, probs, mc)


def _moe_ep(x2, gates, idx, probs, p, mc, mesh):
    """Expert parallelism on ``x2`` (T, d), this rank's rows (replicated
    over ``'model'``): the rank holds experts ``[m e_loc, (m+1) e_loc)``;
    its ``(E, cap, d)`` buffer goes out in ``|model|`` blocks of ``e_loc``
    experts, each rank runs its experts over every rank's block, and the
    results come back the same way.  Every rank sends the same rows, so
    the return exchange's backward scales by ``1 / |model|`` and the
    entry's sums over ``'model'``: the gradients are the single-device
    ones, the experts' each on its own rank."""
    from ..distributed import collectives as C

    t, d = x2.shape
    msize = C.axis_sizes(mesh)["model"]
    e_loc = mc.n_experts // msize
    lo = mesh.get_local_rank("model") * e_loc
    _, keep, slot, cap = dispatch(idx, mc)
    buf = _buffer(C.enter_tp(x2, mesh), slot, mc, cap).reshape(msize, e_loc, cap, d)
    recv = C.all_to_all(buf, mesh)  # (peers, e_loc, cap, d): their rows for my experts
    recv = recv.transpose(0, 1).reshape(e_loc, msize * cap, d)
    w1, w3, w2 = p["w1"], p["w3"], p["w2"]
    if not p.blocks:
        w1, w3, w2 = (w.narrow(0, lo, e_loc) for w in (w1, w3, w2))
    y = _experts(recv, w1, w3, w2)
    y = y.reshape(e_loc, msize, cap, d).transpose(0, 1)
    back = C.all_to_all(y, mesh, grad_scale=1.0 / msize).reshape(mc.n_experts * cap, d)
    out = _combine(back, slot, gates, keep, t, idx.shape[1], mc, cap)
    return out, _balance(idx, keep, probs, mc)


def moe_form(cfg, mesh) -> str:
    """The MoE form of ``cfg`` on ``mesh``: ``"local"`` (no mesh, or no
    split of the experts' work: ``tp_size <= 1`` or ``expert_ff`` not
    divisible by ``|model|``), ``"tp"`` or ``"ep"`` (``moe_impl or
    impl`` is ``"ep"``, ``tp_size > 1`` and ``|model|`` divides ``E``), as
    the reference selects them."""
    if mesh is None:
        return "local"
    from ..distributed.collectives import axis_sizes

    mc, msize = cfg.moe, axis_sizes(mesh).get("model", 1)
    if (cfg.moe_impl or mc.impl) == "ep" and cfg.tp_size > 1 and mc.n_experts % msize == 0:
        return "ep"
    if cfg.tp_size > 1 and mc.expert_ff % msize == 0:
        return "tp"
    return "local"


def experts_split(cfg, mesh) -> bool:
    """Whether the forms cut the experts over ``'model'`` on ``mesh`` (the
    TP and EP forms): the gradients of whole experts are then partial over
    that axis, and the step sums them there."""
    return bool(cfg.moe) and moe_form(cfg, mesh) in ("tp", "ep")


def moe_apply(p, cfg, x: torch.Tensor, mesh=None):
    """x: (B, S, d) -> ``(out (B, S, d), aux)``, ``aux`` the balance loss
    times ``aux_loss_weight`` (float32).  The router runs in float32;
    capacity counts all B x S tokens of the call.

    With ``mesh`` (a ``DeviceMesh``), ``x`` is this rank's rows (its data
    shard, replicated over ``'model'``); the experts run in
    ``moe_form(cfg, mesh)``, and ``aux``'s value is the mean over the data
    axes (``'model'`` too when ``tp_size <= 1``), its gradient this rank's
    own.
    """
    mc = cfg.moe
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    gates, idx, probs = route(x2.to(torch.float32) @ p["router"], mc)
    if _RECORD is not None:
        _RECORD.append(idx.detach())
    form = moe_form(cfg, mesh)
    if form == "ep":
        out, aux = _moe_ep(x2, gates, idx, probs, p, mc, mesh)
    else:
        out, aux = _dispatch_compute_combine(x2, gates, idx, probs, p, mc,
                                             mesh if form == "tp" else None)
    if mesh is not None:
        from ..distributed.collectives import mean_value
        from ..distributed.sharding import dp_axes

        aux = mean_value(aux, mesh, dp_axes(mesh, cfg.tp_size > 1))
    out = out.reshape(b, s, d)
    if mc.n_shared:
        out = out + swiglu(p["shared"], x)
    return out, aux * mc.aux_loss_weight
