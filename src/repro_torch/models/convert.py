"""Carry the JAX package's parameters into the port's ``Model``.

The JAX ``Model.init`` tree (``{"embed": {"e"}, "final_norm": {"w"},
"stack": {"l0": {...}}, "unembed"}``, every stack leaf with a leading
``n_periods`` axis) becomes the port's ``state_dict``: the stack axis is
unstacked into ``stack.<period>.l0...``, every other path keeps its name.
Every shape is checked, and a missing or extra leaf is refused.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .model import Model

__all__ = ["params_from_jax", "flatten_tree"]


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a": {"b": x}}`` -> ``{"a.b": np.asarray(x)}``."""
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for key, sub in tree.items():
            out.update(flatten_tree(sub, f"{prefix}{key}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def params_from_jax(cfg, params, device=None) -> Model:
    """A port ``Model`` holding the JAX package's parameters.

    Args:
        cfg: The port's ``ArchConfig`` the parameters were made for.
        params: The JAX ``Model.init`` tree, leaves as numpy arrays (or
            anything ``np.asarray`` takes).
        device: Where the model lives; None means the card.

    Returns:
        The loaded ``Model``.

    Raises:
        ValueError: a leaf is missing, extra, or of the wrong shape.
    """
    model = Model(cfg, device=device)
    want = model.state_dict()
    flat = {}
    for name, arr in flatten_tree(params).items():
        if name.startswith("stack."):
            if arr.ndim < 1 or arr.shape[0] != cfg.n_periods:
                raise ValueError(f"{name}: stacked leaf {arr.shape} lacks the leading "
                                 f"n_periods={cfg.n_periods} axis")
            for k in range(cfg.n_periods):
                flat[f"stack.{k}.{name[len('stack.'):]}"] = arr[k]
        else:
            flat[name] = arr
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, extra {extra}")
    for name, arr in flat.items():
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the model wants "
                             f"{tuple(want[name].shape)}")
    with torch.no_grad():
        for name, arr in flat.items():
            want[name].copy_(torch.from_numpy(np.array(arr)))
    return model
