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
tensors the same way), stacks their gradients and parameters, applies the
reference's rule to the stack and writes each period's slice back.  Its
state is the reference's tree, keyed by the reference's dotted leaf
names (``stack.l0.mixer.wq``), in float32.  ``update`` changes the
parameters in place, under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..models.convert import is_stacked, stacked_groups

__all__ = ["Optimizer", "make_optimizer", "warmup_cosine", "clip_by_global_norm",
           "global_norm", "stacked_groups", "is_stacked"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params, step) ->
    (params, state)``, with ``params`` and ``grads`` the port's named
    tensors (``dict(model.named_parameters())``)."""

    init: Callable[[Dict[str, torch.Tensor]], Any]
    update: Callable[..., Tuple[Dict[str, torch.Tensor], Any]]


def _leaf(tensors: Dict[str, torch.Tensor], key: str, members: List[str]) -> torch.Tensor:
    """The reference's leaf: the group's tensors stacked (a stack leaf) or
    the one tensor."""
    if is_stacked(key):
        return torch.stack([tensors[n] for n in members])
    return tensors[members[0]]


def _write(params: Dict[str, torch.Tensor], key: str, members: List[str],
           value: torch.Tensor) -> None:
    if is_stacked(key):
        for k, n in enumerate(members):
            params[n].copy_(value[k])
    else:
        params[members[0]].copy_(value)


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
    """``sqrt(sum g^2)`` over every tensor, in float32."""
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads.values()))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``.

    Returns:
        ``(clipped grads, global norm before clipping)``.

    Example:
        >>> g, n = clip_by_global_norm({"x": torch.full((4,), 100.0)}, 1.0)
        >>> round(float(n), 3), round(float(g["x"].norm()), 5)
        (200.0, 1.0)
    """
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {n: (g * scale).to(g.dtype) for n, g in grads.items()}, gn


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


def _adamw(lr, b1, b2, eps, wd, clip):
    def init(params):
        shapes = _leaf_shapes(params)
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
                         for k, s in shapes.items()}
        return {"m": zeros(), "v": zeros(), "gnorm": torch.zeros((), device=dev)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gn = clip_by_global_norm(grads, clip)
        dev = gn.device
        t = _as_f32(step, dev) + 1.0
        bc1 = 1 - b1**t
        bc2 = 1 - b2**t
        lr_t = _as_f32(lr(step), dev)
        new_m, new_v = {}, {}
        for key, members in stacked_groups(params).items():
            gf = _leaf(grads, key, members).to(torch.float32)
            m2 = b1 * state["m"][key] + (1 - b1) * gf
            v2 = b2 * state["v"][key] + (1 - b2) * gf * gf
            upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            p = _leaf(params, key, members)
            pf = p.to(torch.float32)
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                pf = pf * (1 - lr_t * wd)
            _write(params, key, members, (pf - lr_t * upd).to(p.dtype))
            new_m[key], new_v[key] = m2, v2
        return params, {"m": new_m, "v": new_v, "gnorm": gn}

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
    def update(grads, state, params, step):
        grads, gn = clip_by_global_norm(grads, clip)
        dev = gn.device
        t = _as_f32(step, dev) + 1.0
        beta2t = 1.0 - t**-0.8  # Adafactor's decaying beta2
        lr_t = _as_f32(lr(step), dev)
        new_f = {}
        for key, members in stacked_groups(params).items():
            gf = _leaf(grads, key, members).to(torch.float32)
            s = state["f"][key]
            g2 = gf * gf + 1e-30
            if gf.ndim >= 2:
                vr = beta2t * s["vr"] + (1 - beta2t) * g2.mean(-1)
                vc = beta2t * s["vc"] + (1 - beta2t) * g2.mean(-2)
                r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
                vhat = r[..., None] * vc[..., None, :]
                new_f[key] = {"vr": vr, "vc": vc}
            else:
                vhat = beta2t * s["v"] + (1 - beta2t) * g2
                new_f[key] = {"v": vhat}
            u = gf * torch.rsqrt(vhat + eps)
            del g2, vhat
            # relative update clipping (Adafactor d=1.0), over the whole leaf
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms_u, min=1.0)
            p = _leaf(params, key, members)
            pf = p.to(torch.float32)
            if p.ndim >= 2:
                pf = pf * (1 - lr_t * wd)
            _write(params, key, members, (pf - lr_t * u).to(p.dtype))
        return params, {"f": new_f, "gnorm": gn}

    return Optimizer(init, update)
