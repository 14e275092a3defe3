"""Optimizers: AdamW and Adafactor (factored second moment) over tensors.

The port's counterpart of the JAX package's ``optim/optimizer.py``.  The
reference's leaves are the model's *stacked* arrays: every block
parameter carries a leading ``n_periods`` axis.  The port's ``Model``
keeps one tensor per period (``stack.<k>.l0.mixer.wq``), and three of the
reference's rules read a leaf's shape:

* decoupled weight decay on leaves of ``ndim >= 2`` only, so a stacked
  RMSNorm weight ``(n_periods, d)`` is decayed (and an encoder's,
  ``(encoder_layers, d)``);
* Adafactor factors leaves of ``ndim >= 2`` over their last two axes, so
  that norm weight's column statistics span the periods;
* Adafactor's relative update clipping takes the RMS of the update over
  the whole stacked leaf.

So the optimizer groups each stacked leaf's ``n_periods`` tensors
(``models.convert.stacked_groups``; an encoder's ``encoder.stack.<k>``
tensors the same way) and applies the reference's rule to the group:
period by period where the rule is the period's own (AdamW everywhere,
Adafactor's statistics of a stacked matrix), on the stacked tensors where
it spans the periods (a stack of vectors), with the RMS summed over the
periods.  Its state is the reference's tree, keyed by the reference's
dotted leaf names (``stack.l0.mixer.wq``), in float32.

``update`` writes the new parameters and state into the tensors it is
given, under ``torch.no_grad()``, and consumes ``grads``: each leaf's
gradients leave the dict as the leaf is updated, so a caller that holds
no other reference frees them as it goes.  Each gradient is clipped as
the loop reads it (``clip_by_global_norm``'s scale, no clipped copies),
and a leaf's temporaries are freed before the next leaf's.

The tensors may be one rank's shards of the leaves (``launch/steps.py``):
the update is elementwise but for the global norm and Adafactor's means
and RMS, whose partial sums go through the ``sums`` hook.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models.convert import is_stacked, stacked_groups

__all__ = ["Optimizer", "make_optimizer", "warmup_cosine", "clip_by_global_norm",
           "global_norm", "stacked_groups", "is_stacked"]


# A partial result ``x`` of leaf ``key`` and the dims of the leaf it
# reduced (negative, counted from the leaf's last dim).
Part = Tuple[str, torch.Tensor, Tuple[int, ...]]
# ``sums([(key, x, dims), ...])`` -> ``[(total, ranks), ...]``, in order:
# each ``x`` summed over the ranks of the mesh axes that shard those dims
# of leaf ``key``, and the number of those ranks.
Sums = Callable[[List[Part]], List[Tuple[torch.Tensor, int]]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params, step, *,
    sums=None) -> (params, state)``, with ``params`` and ``grads`` the
    port's named tensors (``dict(model.named_parameters())``).

    ``update`` writes into ``params`` and ``state`` and returns them; it
    empties ``grads``.  ``sums`` (a ``Sums``) is given where the tensors
    are one rank's shards: the global norm sums each leaf's sum of squares
    through it (one call for every leaf), Adafactor its row and column
    means (one call), the rows' mean of those and the RMS of a leaf's
    update.  Without it every leaf is whole.
    """

    init: Callable[[Dict[str, torch.Tensor]], Any]
    update: Callable[..., Tuple[Dict[str, torch.Tensor], Any]]


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor * peak`` at ``total``; the schedule is a function of the step
    (an int or a tensor) that returns a float32 scalar tensor.

    Example:
        >>> lr = warmup_cosine(1.0, 2, 10)
        >>> [round(float(lr(s)), 3) for s in (0, 1, 2, 10)]
        [0.5, 1.0, 1.0, 0.1]
    """
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        wu = peak * (step + 1) / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, wu, peak * cos)

    return lr


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum g^2)`` over every tensor, in float32, as the update
    sums it (leaf by leaf, ``stacked_groups``)."""
    return _clip_scale(grads, grads, stacked_groups(grads), 1.0, _whole)[1]


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``, as
    the update scales each gradient it reads.

    Returns:
        ``(clipped grads, global norm before clipping)``.

    Example:
        >>> g, n = clip_by_global_norm({"x": torch.full((4,), 100.0)}, 1.0)
        >>> round(float(n), 3), round(float(g["x"].norm()), 5)
        (200.0, 1.0)
    """
    scale, gn = _clip_scale(grads, grads, stacked_groups(grads), max_norm, _whole)
    return {n: _scaled(g, scale).to(g.dtype) for n, g in grads.items()}, gn


def make_optimizer(kind: str, lr: Callable, *, b1: float = 0.9, b2: float = 0.95,
                   eps: float = 1e-8, weight_decay: float = 0.1,
                   grad_clip: float = 1.0) -> Optimizer:
    """The reference's ``adamw`` or ``adafactor`` with its defaults.

    Raises:
        ValueError: another ``kind``.
    """
    if kind == "adamw":
        return _adamw(lr, b1, b2, eps, weight_decay, grad_clip)
    if kind == "adafactor":
        return _adafactor(lr, b2, eps, weight_decay, grad_clip)
    raise ValueError(f"unknown optimizer {kind!r}; the port has 'adamw' and 'adafactor'")


def _leaf_shapes(params) -> Dict[str, Tuple[int, ...]]:
    """The reference's shape of each leaf (a stack leaf's periods first)."""
    return {key: ((len(members),) if is_stacked(key) else ())
            + tuple(params[members[0]].shape)
            for key, members in stacked_groups(params).items()}


def _whole(parts: List[Part]) -> List[Tuple[torch.Tensor, int]]:
    """The mesh-less ``sums``: every leaf lies whole on this rank."""
    return [(x, 1) for _, x, _ in parts]


def _ndim(params, key: str, members: List[str]) -> int:
    """The reference's rank of leaf ``key`` (a stack leaf's periods count)."""
    return params[members[0]].ndim + is_stacked(key)


def _clip_scale(grads, params, groups, clip: float, sums: Sums):
    """``(scale, gnorm)``: ``clip_by_global_norm``'s scale and norm, from
    each leaf's sum of squares summed over the ranks that shard it."""
    parts = [(key, sum(torch.sum(grads[n].to(torch.float32) ** 2) for n in members),
              tuple(range(-_ndim(params, key, members), 0)))
             for key, members in groups.items()]
    gn = torch.sqrt(sum(x for x, _ in sums(parts)))
    return torch.clamp(clip / (gn + 1e-9), max=1.0), gn


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A gradient clipped as ``clip_by_global_norm`` clips it, in float32
    (a new tensor: the caller's gradient is not written)."""
    return (g * scale).to(g.dtype).to(torch.float32)


def _means(sums: Sums, key: str, x: torch.Tensor, dims, keepdim: bool = False):
    """``[x.mean(d) for d, _ in dims]`` of this rank's block ``x`` of a
    statistic of leaf ``key``, whose dim ``d`` is the leaf's ``leaf_d``
    (``dims``: ``(d, leaf_d)`` pairs): each block sum summed over the
    ranks that shard that leaf dim, over the dim's global length; one
    ``sums`` call for all."""
    totals = sums([(key, x.sum(d, keepdim=keepdim), (leaf_d,)) for d, leaf_d in dims])
    return [total / (x.shape[d] * ranks) for (total, ranks), (d, _) in zip(totals, dims)]


def _apply(p: torch.Tensor, u: torch.Tensor, lr_t, decay) -> None:
    """``p = p * decay - lr_t * u`` in float32, written into ``p`` (no
    decay where ``decay`` is None); ``u`` is overwritten."""
    pf = p if p.dtype == torch.float32 else p.to(torch.float32)
    if decay is not None:
        pf.mul_(decay)
    pf.sub_(u.mul_(lr_t))
    if pf is not p:
        p.copy_(pf)


def _adamw(lr, b1, b2, eps, wd, clip):
    def init(params):
        shapes = _leaf_shapes(params)
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
                         for k, s in shapes.items()}
        return {"m": zeros(), "v": zeros(), "gnorm": torch.zeros((), device=dev)}

    @torch.no_grad()
    def update(grads, state, params, step, *, sums: Optional[Sums] = None):
        groups = stacked_groups(params)
        scale, gn = _clip_scale(grads, params, groups, clip, sums or _whole)
        dev = gn.device
        t = _as_f32(step, dev) + 1.0
        bc1 = 1 - b1**t
        bc2 = 1 - b2**t
        lr_t = _as_f32(lr(step), dev)
        decay = 1 - lr_t * wd
        for key, members in groups.items():
            matrix = _ndim(params, key, members) >= 2  # decoupled decay on matrices only
            for k, name in enumerate(members):  # elementwise: a period at a time
                m, v = state["m"][key], state["v"][key]
                if is_stacked(key):
                    m, v = m[k], v[k]
                gf = _scaled(grads.pop(name), scale)
                tmp = gf * (1 - b1)
                m.mul_(b1).add_(tmp)  # b1 * m + (1 - b1) * g
                v.mul_(b2).add_(torch.mul(gf, 1 - b2, out=tmp).mul_(gf))
                del gf
                upd = torch.div(m, bc1, out=tmp).div_(torch.div(v, bc2).sqrt_().add_(eps))
                _apply(params[name], upd, lr_t, decay if matrix else None)
                del tmp, upd
        state["gnorm"].copy_(gn)
        return params, state

    return Optimizer(init, update)


def _adafactor(lr, b2, eps, wd, clip):
    """Factored second moment for leaves of ``ndim >= 2`` (row and column
    statistics over the last two axes); no first moment."""

    def init(params):
        shapes = _leaf_shapes(params)
        dev = next(iter(params.values())).device
        z = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        f = {k: ({"vr": z(s[:-1]), "vc": z(s[:-2] + s[-1:])} if len(s) >= 2 else {"v": z(s)})
             for k, s in shapes.items()}
        return {"f": f, "gnorm": z(())}

    @torch.no_grad()
    def update(grads, state, params, step, *, sums: Optional[Sums] = None):
        sums = sums or _whole
        groups = stacked_groups(params)
        scale, gn = _clip_scale(grads, params, groups, clip, sums)
        dev = gn.device
        t = _as_f32(step, dev) + 1.0
        beta2t = 1.0 - t**-0.8  # Adafactor's decaying beta2
        lr_t = _as_f32(lr(step), dev)
        decay = 1 - lr_t * wd
        for key, members in groups.items():
            s, nd = state["f"][key], _ndim(params, key, members)
            if is_stacked(key) and nd == 2:
                # a stack of vectors: its column statistics span the periods
                units = [(torch.stack([_scaled(grads.pop(n), scale) for n in members]),
                          torch.stack([params[n] for n in members]), s)]
            else:  # a period at a time: the statistics are the period's own
                units = [(_scaled(grads.pop(n), scale), params[n],
                          {i: x[k] for i, x in s.items()} if is_stacked(key) else s)
                         for k, n in enumerate(members)]
            usq = 0
            for u, _, st in units:  # u: the gradient, made the update in place
                g2 = (u * u).add_(1e-30)
                if nd >= 2:
                    row, col = _means(sums, key, g2, ((-1, -1), (-2, -2)))
                    del g2
                    vr = st["vr"].mul_(beta2t).add_((1 - beta2t) * row)
                    vc = st["vc"].mul_(beta2t).add_((1 - beta2t) * col)
                    (den,) = _means(sums, key, vr, ((-1, -2),), keepdim=True)
                    r = vr / torch.clamp(den, min=1e-30)
                    vhat = r[..., None] * vc[..., None, :]
                    u.mul_(vhat.add_(eps).rsqrt_())
                    del vhat
                else:
                    v = st["v"].mul_(beta2t).add_(g2.mul_(1 - beta2t))  # v is vhat
                    u.mul_(torch.add(v, eps, out=g2).rsqrt_())
                    del g2
                usq = usq + torch.sum(u * u)
            # relative update clipping (Adafactor d=1.0), over the whole leaf
            ((total, ranks),) = sums([(key, usq, tuple(range(-nd, 0)))])
            rms_u = torch.sqrt(total / (sum(u.numel() for u, _, _ in units) * ranks) + 1e-30)
            den = torch.clamp(rms_u, min=1.0)
            for u, p, _ in units:
                _apply(p, u.div_(den), lr_t, decay if nd >= 2 else None)
            if is_stacked(key) and nd == 2:
                for k, n in enumerate(members):
                    params[n].copy_(units[0][1][k])
            del units
        state["gnorm"].copy_(gn)
        return params, state

    return Optimizer(init, update)
