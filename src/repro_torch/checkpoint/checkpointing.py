"""Atomic checkpoints, the JAX package's ``checkpoint/checkpointing.py``.

Layout (the reference's, so either package restores the other's)::

    <dir>/step_<N>/
        manifest.json     # step, and each leaf's file, shape and dtype
        <leaf-path>.npy   # one file per leaf, "/" in the path as "__"
    <dir>/LATEST          # atomically updated pointer

A tree is nested dicts, lists and tuples of tensors (or numpy arrays);
a leaf's path joins its keys with ``/`` (``params/stack/l0/mixer/wq``).
Guarantees the trainer's resume relies on:

* a save writes ``step_<N>.tmp``, fsyncs its manifest and renames it, so
  a failure mid-save never corrupts an earlier checkpoint;
* ``restore_latest`` takes the newest complete checkpoint;
* the data pipeline is stateless (step -> batch), so a resume is exact.

The port runs on one device: there are no shardings; a restored leaf
takes the dtype and device of the prototype's leaf.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save", "restore", "restore_latest", "latest_step", "list_steps"]


def _flatten(tree, prefix: str = "") -> dict:
    """Flatten a dict/list tree to ``{'a/b/0': leaf}`` path keys."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _fsync_write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomic save of ``tree`` as checkpoint ``step``.  Returns its path."""
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in flat.items():
        arr = _numpy(leaf)
        fn = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][name] = {"file": fn, "shape": list(arr.shape),
                                    "dtype": str(arr.dtype)}
    _fsync_write(os.path.join(tmp, "manifest.json"), json.dumps(manifest, indent=1))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    ptr_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    _fsync_write(ptr_tmp, str(step))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def list_steps(ckpt_dir: str) -> list:
    """Sorted steps of every *complete* checkpoint in ``ckpt_dir`` (one
    whose ``manifest.json`` exists, so after the rename); empty when the
    directory does not exist."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None.

    Prefers the ``LATEST`` pointer when it names a complete checkpoint (a
    pointer written just before a crash may not), else the newest
    complete step.

    Example:
        >>> import tempfile
        >>> d = tempfile.mkdtemp()
        >>> latest_step(d) is None
        True
        >>> _ = save(d, 3, {"w": torch.zeros(2)})
        >>> _ = save(d, 7, {"w": torch.ones(2)})
        >>> latest_step(d)
        7
    """
    steps = list_steps(ckpt_dir)
    if not steps:
        return None
    ptr = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(ptr):
        try:
            with open(ptr) as f:
                s = int(f.read().strip())
            if s in steps:
                return s
        except ValueError:
            pass
    return steps[-1]


def restore(ckpt_dir: str, step: int, proto: Any) -> Any:
    """Checkpoint ``step`` shaped like ``proto``: each leaf a tensor of
    the prototype leaf's dtype and device (a CPU tensor of the file's
    dtype where the prototype leaf is no tensor).

    Raises:
        KeyError: a leaf of ``proto`` is not in the checkpoint.
        ValueError: a leaf's shape differs from the prototype's.
    """
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(proto)
    out = {}
    for name, want in flat.items():
        meta = manifest["leaves"][name]
        t = torch.from_numpy(np.load(os.path.join(path, meta["file"])))
        if isinstance(want, torch.Tensor):
            if tuple(t.shape) != tuple(want.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)}, the "
                                 f"prototype's {tuple(want.shape)}")
            t = t.to(device=want.device, dtype=want.dtype)
        out[name] = t

    def rebuild(node, prefix=""):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v, f"{prefix}{i}/") for i, v in enumerate(node))
        return out[prefix[:-1]]

    return rebuild(proto)


def restore_latest(ckpt_dir: str, proto: Any):
    """``(tree, step)`` of the newest complete checkpoint, or ``(None,
    None)`` for a cold start."""
    s = latest_step(ckpt_dir)
    if s is None:
        return None, None
    return restore(ckpt_dir, s, proto), s
