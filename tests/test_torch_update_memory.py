"""What one optimizer update holds on one card, counted on the CPU.

A dispatch mode counts the live bytes of every storage the update
allocates (an op's output whose storage none of its inputs holds), from
its allocation until a finalizer on the storage sees it freed, and keeps
the peak.  On a reduced config, deepened so that four copies of its
largest leaf are less than its parameters: with AdamW and with Adafactor
the update allocates no per-parameter copy (no clipped gradients, no new
state: the state is written in place) and at most four copies of the
largest leaf (the reference's stacked leaf), and every gradient it is
given is freed once its leaf is updated.  No JAX: the update's numbers are
held against the reference in ``tests/test_torch_optim.py``.
"""

import math
import weakref

import numpy as np
import port_threads  # noqa: F401  (one torch thread a worker)
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.ALL import REDUCED
from repro_torch.models.model import Model
from repro_torch.optim.optimizer import (is_stacked, make_optimizer, stacked_groups,
                                         warmup_cosine)

LAYERS = 8
COPIES = 4  # of the largest leaf, the most the update may hold at once


class LiveBytes(TorchDispatchMode):
    """The live and peak bytes of the storages allocated under the mode."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def _freed(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        result = func(*args, **(kwargs or {}))
        held = {t.untyped_storage().data_ptr() for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)}
        for t in tree_flatten(result)[0]:
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in held:
                storage = t.untyped_storage()
                held.add(storage.data_ptr())
                self.live += storage.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(storage, self._freed, storage.nbytes())
        return result


def _setup(arch, kind):
    cfg = REDUCED[arch]().replace(act_dtype="float32", param_dtype="float32",
                                  n_layers=LAYERS, optimizer=kind)
    params = {n: p.detach() for n, p in Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).named_parameters()}
    rng = np.random.default_rng(1)
    # large enough that the clip's scale is below 1 (the clipped path)
    grads = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
             for n, p in params.items()}
    largest = max(4 * math.prod(p.shape) * (len(ms) if is_stacked(k) else 1)
                  for k, ms in stacked_groups(params).items() for p in [params[ms[0]]])
    return params, grads, largest


@pytest.mark.parametrize("arch,kind", [("yi-6b", "adamw"), ("internlm2-20b", "adafactor"),
                                       ("yi-6b", "adafactor")])
def test_update_holds_no_copy_of_the_parameters(arch, kind):
    params, grads, largest = _setup(arch, kind)
    total = sum(4 * p.numel() for p in params.values())
    assert COPIES * largest < total  # so the bound excludes a per-parameter copy
    opt = make_optimizer(kind, warmup_cosine(1e-2, 2, 10))
    state = opt.init(params)
    before = [(t, t.data_ptr()) for t in tree_flatten(state)[0]]
    freed = []
    for g in grads.values():
        weakref.finalize(g.untyped_storage(), freed.append, g.untyped_storage().nbytes())
    del g
    n_grads = len(grads)
    mode = LiveBytes()
    with mode:
        new_params, new_state = opt.update(grads, state, params, 0)
    assert new_params is params and new_state is state
    assert all(t.data_ptr() == ptr for t, ptr in before)  # the state written in place
    assert 0 < float(state["gnorm"]) and float(state["gnorm"]) > 1.0  # the clip scaled
    assert grads == {} and len(freed) == n_grads  # every gradient released
    assert mode.peak <= COPIES * largest, (mode.peak / largest, "copies of the largest leaf")
