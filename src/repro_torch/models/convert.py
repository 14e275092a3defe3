"""Carry the JAX package's parameters into the port's ``Model``.

The JAX ``Model.init`` tree (``{"embed": {"e"}, "final_norm": {"w"},
"stack": {"l0": {...}, "l1": ...}, "unembed"}``, plus ``"prefix": {"p0":
{...}}`` and ``"mtp": {"proj", "block", "norm"}`` where the config has
them) becomes the port's ``state_dict``.  Every stack leaf carries a
leading ``n_periods`` axis, the experts' too (``stack.l0.ffn.w1`` is
``(n_periods, E, d, expert_ff)``); that axis is unstacked into
``stack.<period>.l0...``.  The prefix and MTP leaves are not stacked and
keep their names, as every other path does.  Every shape is checked,
and a missing or extra leaf is refused.
``stacked_params`` and ``load_stacked`` go both ways between the port's
model and that flat stacked tree (the trainer's checkpoints hold it).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .model import Model

__all__ = ["params_from_jax", "flatten_tree", "stacked_params", "load_stacked"]


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
    load_stacked(model, flatten_tree(params))
    return model


def stacked_params(model: Model) -> Dict[str, torch.Tensor]:
    """The model's parameters as the JAX package's flat tree: every block
    leaf stacked over the periods (``stack.l0.mixer.wq`` of shape
    ``(n_periods, ...)``, a copy), every other leaf as it is."""
    out: Dict[str, torch.Tensor] = {}
    per: Dict[str, list] = {}
    for name, p in model.state_dict().items():
        if name.startswith("stack."):
            _, _, rest = name.split(".", 2)
            per.setdefault(f"stack.{rest}", []).append(p)
        else:
            out[name] = p
    out.update({name: torch.stack(ps) for name, ps in per.items()})
    return out


def load_stacked(model: Model, flat) -> Model:
    """Copy the JAX package's flat tree (``flatten_tree`` names, stacked
    block leaves; numpy arrays or tensors) into ``model``.

    Raises:
        ValueError: a leaf is missing, extra, or of the wrong shape.
    """
    cfg = model.cfg
    want = model.state_dict()
    unstacked = {}
    for name, arr in flat.items():
        if name.startswith("stack."):
            if arr.ndim < 1 or arr.shape[0] != cfg.n_periods:
                raise ValueError(f"{name}: stacked leaf {tuple(arr.shape)} lacks the leading "
                                 f"n_periods={cfg.n_periods} axis")
            for k in range(cfg.n_periods):
                unstacked[f"stack.{k}.{name[len('stack.'):]}"] = arr[k]
        else:
            unstacked[name] = arr
    missing = sorted(set(want) - set(unstacked))
    extra = sorted(set(unstacked) - set(want))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, extra {extra}")
    for name, arr in unstacked.items():
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the model wants "
                             f"{tuple(want[name].shape)}")
    with torch.no_grad():
        for name, arr in unstacked.items():
            src = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
            want[name].copy_(src)
    return model
