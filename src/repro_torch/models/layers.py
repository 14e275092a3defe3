"""Shared model layers: dense init, RMSNorm, LayerNorm, NeoX RoPE, M-RoPE,
SwiGLU, embeddings.

Each layer is a function on tensors that takes its parameters as a
mapping (``p["w"]``), as the JAX package's ``models/layers.py`` does, plus
a thin ``nn.Module`` that holds those parameters under the same names
and can be indexed like the mapping, so a JAX parameter tree maps onto
the port's ``state_dict`` leaf for leaf.  ``layernorm`` is part of the
reference's public layers; no model calls it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = [
    "dense_init",
    "rmsnorm",
    "layernorm",
    "rope",
    "mrope",
    "swiglu",
    "embed",
    "Params",
    "RMSNorm",
    "SwiGLU",
    "Embed",
]


def dense_init(shape: Sequence[int], generator: torch.Generator, dtype=torch.float32,
               scale: Optional[float] = None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Truncated-normal fan-in init on [-2, 2] (``shape[-2]`` is fan-in).

    Args:
        shape: Weight shape.
        generator: Where the random numbers come from; the tensor is made
            on the generator's device.
        dtype: Result dtype.
        scale: Multiplier; None means ``fan_in ** -0.5``.
        out: Fill this tensor in place instead of allocating one.

    Returns:
        The initialised tensor.

    Example:
        >>> g = torch.Generator().manual_seed(0)
        >>> w = dense_init((16, 4), g)
        >>> bool(w.abs().max() <= 2 * 16 ** -0.5)
        True
    """
    fan_in = shape[0] if len(shape) == 2 else shape[-2]
    if scale is None:
        scale = fan_in**-0.5
    if out is None:
        out = torch.empty(tuple(shape), dtype=dtype, device=generator.device)
    with torch.no_grad():
        nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
        out.mul_(scale)
    return out


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x / rms(x) * w`` with the statistics in float32."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * p["w"].to(dt)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) / std * w + b`` with the statistics in float32 (the
    population variance)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * p["w"].to(dt) + p["b"].to(dt)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _inv_freq(half: int, theta: float, device) -> torch.Tensor:
    """The rotary frequencies ``theta ** (-i / half)``, float32."""
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def _rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, dim/2), float32."""
    freq = _inv_freq(dim // 2, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6) -> torch.Tensor:
    """NeoX-style rotary embedding.  x: (B, H, S, D); positions: (B, S)."""
    d = x.shape[-1]
    cos, sin = _rope_angles(positions, d, theta)
    return _rotate(x, cos[:, None], sin[:, None])  # (B, 1, S, D/2) angles


def mrope(x: torch.Tensor, positions3: torch.Tensor, sections: Tuple[int, int, int],
          theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.

    Args:
        x: (B, H, S, D).
        positions3: (B, S, 3), the (t, h, w) position streams.
        sections: How many of the D/2 frequency slots each stream drives,
            in order; they sum to D/2.
        theta: The RoPE base.

    Returns:
        x rotated NeoX-style, in x's dtype.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to head_dim/2 = {half}")
    dev = x.device
    # frequency slot -> the position stream that drives it, made on the
    # device (no copy from the host inside a captured decode)
    sec_id = torch.cat([torch.full((n,), i, dtype=torch.long, device=dev)
                        for i, n in enumerate(sections)])
    pos = positions3.to(torch.float32).index_select(-1, sec_id)  # (B, S, half)
    ang = pos * _inv_freq(half, theta, dev)
    return _rotate(x, torch.cos(ang)[:, None], torch.sin(ang)[:, None])


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    """``(silu(x w1) * (x w3)) w2``."""
    dt = x.dtype
    g = x @ p["w1"].to(dt)
    u = x @ p["w3"].to(dt)
    return (nn.functional.silu(g) * u) @ p["w2"].to(dt)


def embed(p, tokens: torch.Tensor, act_dtype) -> torch.Tensor:
    """Rows of the embedding table ``p["e"]`` for ``tokens``."""
    return p["e"][tokens].to(act_dtype)


class Params(nn.Module):
    """A module of named parameters that can be indexed like a mapping
    (``p["w"]``), so the layer functions take it or a dict alike.  Its
    submodules are indexed the same way (``p["q_norm"]["w"]``).

    Args:
        shapes: Parameter name -> shape.
        dtype: The parameters' dtype.
        device: Where they live.
        float32: Names kept in float32 whatever ``dtype`` is (the
            reference's router and SSM constants).
    """

    def __init__(self, shapes: dict, dtype, device, float32: Sequence[str] = ()):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=torch.float32 if name in float32 else dtype,
                            device=device), requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]


class RMSNorm(Params):
    """RMSNorm parameters ``{"w": (dim,)}``, initialised to ones."""

    def __init__(self, dim: int, dtype, device):
        super().__init__({"w": (dim,)}, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        """Set the scale to ones (the generator is not read)."""
        with torch.no_grad():
            self["w"].fill_(1.0)


class SwiGLU(Params):
    """SwiGLU parameters ``{"w1", "w3": (d_model, d_ff), "w2": (d_ff, d_model)}``."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__({"w1": (d_model, d_ff), "w3": (d_model, d_ff),
                          "w2": (d_ff, d_model)}, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        """Fan-in truncated normals, in the order w1, w3, w2."""
        for name in ("w1", "w3", "w2"):
            dense_init(self[name].shape, generator, out=self[name].data)


class Embed(Params):
    """Embedding table ``{"e": (vocab, d_model)}``, unit truncated normal."""

    def __init__(self, vocab: int, d_model: int, dtype, device):
        super().__init__({"e": (vocab, d_model)}, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        """Truncated normal on [-2, 2] with scale 1."""
        dense_init(self["e"].shape, generator, scale=1.0, out=self["e"].data)
