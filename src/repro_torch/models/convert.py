"""Carry the JAX package's parameters into the port's ``Model``.

The JAX ``Model.init`` tree (``{"embed": {"e"}, "final_norm": {"w"},
"stack": {"l0": {...}, "l1": ...}, "unembed"}``, plus ``"prefix": {"p0":
{...}}`` and ``"mtp": {"proj", "block", "norm"}`` where the config has
them, and ``"encoder": {"stack", "final_norm"}`` in an encoder-decoder
model) becomes the port's ``state_dict``.  Every stack leaf carries a
leading ``n_periods`` axis, the experts' and the sLSTM's recurrent
kernels too (``stack.l0.ffn.w1`` is ``(n_periods, E, d, expert_ff)``,
``stack.l3.mixer.r`` ``(n_periods, 4, H, dh, dh)``); that axis is
unstacked into ``stack.<period>.l0...``.  The encoder's stack leaves
carry ``encoder_layers`` the same way (``encoder.stack.<layer>.l0...``).
The prefix, MTP and ``encoder.final_norm`` leaves are not stacked and
keep their names, as every other path does.  ``stacked_groups`` is that
naming rule, which the optimizer applies too.  Every shape is checked,
and a missing or extra leaf is refused.
``stacked_params`` and ``load_stacked`` go both ways between the port's
model and that flat stacked tree (the trainer's checkpoints hold it).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from .model import Model

__all__ = ["params_from_jax", "flatten_tree", "stacked_params", "load_stacked",
           "stacked_groups", "is_stacked", "STACKS"]

# The reference's stacked subtrees, each with the config field that gives
# its depth: every leaf under one carries a leading axis over its layers.
STACKS = {"stack": "n_periods", "encoder.stack": "encoder_layers"}
_LAYER = re.compile(r"^(stack|encoder\.stack)\.(\d+)\.(.+)$")


def stacked_groups(names) -> Dict[str, List[str]]:
    """The reference's leaf name of each parameter group, in the order
    the names come: ``stack.<k>.<path>`` for ``k = 0..n-1`` become the
    one stacked leaf ``stack.<path>`` (periods in order), and
    ``encoder.stack.<k>.<path>`` the leaf ``encoder.stack.<path>``; every
    other name is a leaf of its own.

    Example:
        >>> stacked_groups(["embed.e", "stack.0.l0.norm1.w", "stack.1.l0.norm1.w"])
        {'embed.e': ['embed.e'], 'stack.l0.norm1.w': ['stack.0.l0.norm1.w', 'stack.1.l0.norm1.w']}
        >>> stacked_groups(["encoder.stack.0.l0.norm1.w", "encoder.stack.1.l0.norm1.w"])
        {'encoder.stack.l0.norm1.w': ['encoder.stack.0.l0.norm1.w', 'encoder.stack.1.l0.norm1.w']}
    """
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for name in names:
        hit = _LAYER.match(name)
        key, k = ((f"{hit.group(1)}.{hit.group(3)}", int(hit.group(2))) if hit
                  else (name, -1))
        groups.setdefault(key, []).append((k, name))
    return {key: [n for _, n in sorted(members)] for key, members in groups.items()}


def _stack_of(key: str):
    """The stacked subtree of the reference's leaf ``key``, or None."""
    return next((p for p in STACKS if key.startswith(p + ".")), None)


def is_stacked(key: str) -> bool:
    """Whether the reference's leaf ``key`` (a ``stacked_groups`` key) is
    stacked over layers."""
    return _stack_of(key) is not None


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
    ``(n_periods, ...)``, a copy; the encoder's over its layers), every
    other leaf as it is."""
    sd = model.state_dict()
    return {key: torch.stack([sd[n] for n in members]) if is_stacked(key) else sd[members[0]]
            for key, members in stacked_groups(sd).items()}


def load_stacked(model: Model, flat) -> Model:
    """Copy the JAX package's flat tree (``flatten_tree`` names, stacked
    block leaves; numpy arrays or tensors) into ``model``.

    Raises:
        ValueError: a leaf is missing, extra, or of the wrong shape (a
            stacked leaf's leading axis included).
    """
    want = model.state_dict()
    groups = stacked_groups(want)
    missing = sorted(set(groups) - set(flat))
    extra = sorted(set(flat) - set(groups))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, extra {extra}")
    parts = {}
    for key, members in groups.items():
        arr = flat[key]
        if is_stacked(key):
            if arr.ndim < 1 or arr.shape[0] != len(members):
                raise ValueError(f"{key}: stacked leaf {tuple(arr.shape)} lacks the leading "
                                 f"{STACKS[_stack_of(key)]}={len(members)} axis")
            parts.update(zip(members, arr))
        else:
            parts[members[0]] = arr
    for name, arr in parts.items():
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the model wants "
                             f"{tuple(want[name].shape)}")
    with torch.no_grad():
        for name, arr in parts.items():
            src = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
            want[name].copy_(src)
    return model
