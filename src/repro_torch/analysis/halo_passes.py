"""Halo conformance: CA's declared neighbourhood against what it reads.

The port's counterpart of the JAX package's
``repro/analysis/halo_passes.py``.  A body that reads its neighbours
declares them: ``CABody.stencil(m)``, the element offsets one cell's
update reads (itself and its ``3^m - 1`` neighbours), and
``CABody.boundary(m)``, ``'periodic'`` (m=2 wraps on the underlying
square) or ``'free'`` (m >= 3).  This pass checks the declaration against
the two things that read:

* the plain version: ``plain_`` runs on a small state under a dispatch
  mode that records every read of the input (``aten.index`` on its
  flattened view).  Each tile chunk reads the centre first, then one
  neighbour a read, cell for cell, so each read's offset from its cell is
  known.  An offset read at a cell whose neighbours are all in range
  that the declaration lacks is an **undeclared read**; a declared offset never
  read is a **stale declaration**; at the boundary a read must be the
  neighbour the declared rule gives (wrapped mod n, or clamped in range
  and masked, under ``'free'``);
* ``ca.cu``'s staging: one warp stages ``CABody.warp_bytes`` of halo
  slice (``(rho+2)^(m-1)`` rows of ``rho + 2L`` cells), which must hold
  the tile and the declaration's reach on every side.

The reference's ``(m, nb, kind)`` cases (``HALO_MN``) at ``rho = 2``; no
kernel is launched.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels.engine import _chunks as _engine_chunks
from .registry import Finding, LintContext, register_pass
from .schedule_passes import eval_schedule_map

__all__ = ["HALO_MN", "HALO_RHO", "check_body_halo", "staged_reach"]

# The reference's cases: a power-of-two walk, the bounding box (invalid
# steps) and a composite walk at m=3.
HALO_MN: Tuple[Tuple[int, int, str], ...] = (
    (2, 4, "hmap"), (2, 4, "bb"), (3, 4, "hmap"), (3, 4, "bb"), (3, 3, "composite"))
HALO_RHO = 2


class _Reads(TorchDispatchMode):
    """Every index tensor of an ``aten.index`` on ``src``'s storage."""

    def __init__(self, src: torch.Tensor):
        super().__init__()
        self.ptr, self.reads = src.data_ptr(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.index.Tensor and args[0].data_ptr() == self.ptr:
            self.reads.append(args[1][0].clone())
        return func(*args, **(kwargs or {}))


def staged_reach(m: int, rho: int, itemsize: int = 4, vector: bool = False) -> int:
    """The cells ``ca.cu`` stages past a tile on each side, read off its
    halo slice size (``CABody.warp_bytes``): the least ``r`` with
    ``(rho + 2r)^m`` cells (16-byte rounded) at least the slice.

    Example:
        >>> staged_reach(2, 16), staged_reach(3, 4)
        (1, 1)
    """
    from ..kernels.engine import CABody

    size = CABody.warp_bytes(m, rho, itemsize, vector)
    r = 0
    while -(-((rho + 2 * r) ** m * itemsize) // 16) * 16 < size:
        r += 1
    return r


def check_body_halo(body, m: int, nb: int, kind: str, rho: int = HALO_RHO) -> List[Finding]:
    """Findings of one body's declaration at one (m, nb, kind)."""
    from ..core.schedule import SimplexSchedule, resolve_kind

    where = f"<semantic:body {body.name} m={m} nb={nb} kind={kind}>"
    declared = set(map(tuple, body.stencil(m)))
    boundary = body.boundary(m)
    n = nb * rho
    out: List[Finding] = []
    reach = max(max(abs(c) for c in d) for d in declared)
    staged = staged_reach(m, rho)
    if staged < reach:
        out.append(Finding("halo-conformance", where, 0, f"ca.cu stages {staged} cell(s) "
                           f"past a tile; the declaration reaches {reach}"))
    inp = (torch.arange(n**m, dtype=torch.int64) % 2).reshape((n,) * m)
    sched = SimplexSchedule(m, nb, resolve_kind(m, nb, kind))
    spy = _Reads(inp)
    with spy:
        body.plain_(inp.clone(), inp, sched, rho)
    # the plain version's tile chunks (engine._chunks), each read centre first
    chunks = len(list(_engine_chunks(int(eval_schedule_map(sched)[1].sum()), rho**m)))
    if not spy.reads or len(spy.reads) % chunks:
        return out + [Finding("halo-conformance", where, 0, f"the plain version reads "
                              f"{len(spy.reads)} times over {chunks} tile chunks")]
    per = len(spy.reads) // chunks
    groups = [spy.reads[i:i + per] for i in range(0, len(spy.reads), per)]
    seen, miss = set(), None
    for group in groups:
        cell = np.stack(np.unravel_index(group[0].numpy(), (n,) * m), -1)
        inner = ((cell >= 1) & (cell < n - 1)).all(-1)  # every neighbour in range
        for read in group:
            got = np.stack(np.unravel_index(read.numpy(), (n,) * m), -1)
            offsets = set(map(tuple, (got - cell)[inner].tolist()))
            seen |= offsets
            if len(offsets) == 1:  # one read, one offset: its image at the edge
                miss = miss or _boundary_miss(got, cell, offsets.pop(), boundary, n, ~inner)
    if miss:
        out.append(Finding("halo-conformance", where, 0, miss))
    for d in sorted(seen - declared):
        out.append(Finding("halo-conformance", where, 0, f"undeclared read: the plain "
                           f"version reads offset {d}, which {body.name}.stencil({m}) lacks"))
    for d in sorted(declared - seen):
        out.append(Finding("halo-conformance", where, 0, f"stale declaration: "
                           f"{body.name}.stencil({m}) declares offset {d} the plain version "
                           "never reads"))
    return out


def _boundary_miss(got, cell, d, boundary, n, edge) -> Optional[str]:
    """At the cells in ``edge``, a read of offset ``d`` that is not the
    declared rule's image of ``cell + d``: wrapped mod n (periodic), or
    clamped into range (free, the value then masked)."""
    t = cell[edge] + np.asarray(d)
    want = t % n if boundary == "periodic" else np.clip(t, 0, n - 1)
    bad = np.nonzero(~(want == got[edge]).all(-1))[0]
    if not bad.size:
        return None
    i = int(bad[0])
    return (f"at boundary cell {tuple(cell[edge][i].tolist())} the plain version reads "
            f"offset {d} at {tuple(got[edge][i].tolist())}, not its {boundary} image "
            f"{tuple(want[i].tolist())}")


def _halo_bodies():
    """Registered bodies that declare a neighbourhood."""
    from ..kernels.engine import get_body, registered_bodies

    for name in registered_bodies():
        body = get_body(name)
        if hasattr(body, "stencil"):
            yield body


@register_pass("halo-conformance", "semantic",
               "CA's declared stencil matches its plain version's reads and ca.cu's staging")
def _halo_pass(ctx: LintContext, combos: Optional[Sequence] = None) -> List[Finding]:
    out: List[Finding] = []
    for body in _halo_bodies():
        for m, nb, kind in (combos or HALO_MN):
            out.extend(check_body_halo(body, m, nb, kind))
    return out
