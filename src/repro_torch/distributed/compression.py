"""Gradient compression for the cross-pod (``'pod'``) hop, with error
feedback.

The port's counterpart of the JAX package's ``distributed/compression.py``,
on dicts of tensors (nested dicts too):

* ``compress_bf16``: 2x, gradients cast to bfloat16 for the cross-pod
  reduction; the rounding error is kept and added back next step (error
  feedback keeps the accumulated signal unbiased);
* ``compress_int8``: 4x, per-tensor absmax int8 with error feedback, and
  ``decompress_int8`` back to float32.

Both libraries round half to even (the float32 -> bfloat16 cast and
``round``) and divide correctly rounded, so the results equal the
reference's bit for bit, on the CPU and on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

__all__ = ["init_error_state", "compress_bf16", "compress_int8", "decompress_int8"]


def _map(fn: Callable, *trees):
    """``fn`` over the leaves of parallel trees of dicts."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _split(out):
    """A tree of pairs -> a pair of trees."""
    if isinstance(out, dict):
        parts = {k: _split(v) for k, v in out.items()}
        return ({k: p[0] for k, p in parts.items()}, {k: p[1] for k, p in parts.items()})
    return out


def init_error_state(params_like: Any) -> Any:
    """Zero float32 error accumulators shaped like ``params_like``.

    Example:
        >>> init_error_state({"w": torch.ones(2, 3)})["w"].dtype
        torch.float32
    """
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                params_like)


def compress_bf16(grads: Any, err: Any) -> Tuple[Any, Any]:
    """Returns ``(bfloat16 gradients with the fed-back error, new error)``.

    Example:
        >>> g = {"w": torch.tensor([1.0 + 2 ** -10])}
        >>> comp, err = compress_bf16(g, init_error_state(g))
        >>> float(comp["w"]), float(err["w"])
        (1.0, 0.0009765625)
    """
    def one(g, e):
        gf = g.to(torch.float32) + e
        q = gf.to(torch.bfloat16)
        return q, gf - q.to(torch.float32)

    return _split(_map(one, grads, err))


def compress_int8(grads: Any, err: Any) -> Tuple[Any, Any]:
    """Per-tensor absmax int8; returns ``({name: (q, scale)}, new error)``,
    ``scale = max(max|g + e|, 1e-12) / 127`` in float32 and ``q`` the
    quotient rounded half to even and clipped to [-127, 127].

    Example:
        >>> g = {"w": torch.tensor([-2.0, 0.5, 1.0])}
        >>> comp, err = compress_int8(g, init_error_state(g))
        >>> q, scale = comp["w"]
        >>> q.tolist(), round(float(scale), 6)
        ([-127, 32, 64], 0.015748)
    """
    def one(g, e):
        gf = g.to(torch.float32) + e
        # a tensor divisor: PyTorch multiplies a CUDA tensor by the
        # reciprocal of a Python number, which can differ in the last bit
        scale = torch.clamp(gf.abs().max(), min=1e-12) / gf.new_tensor(127.0)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return (q, scale), gf - q.to(torch.float32) * scale

    return _split(_map(one, grads, err))


def decompress_int8(comp: Any) -> Any:
    """Dequantize a ``compress_int8`` tree back to float32 gradients."""
    if isinstance(comp, dict):
        return {k: decompress_int8(v) for k, v in comp.items()}
    q, scale = comp
    return q.to(torch.float32) * scale
