"""Semantic schedule passes: bijectivity and the port's write discipline.

The port's counterpart of the JAX package's
``repro/analysis/schedule_passes.py``.  Two facts of every walk the
kernels launch, checked by replaying the port's maps on the CPU
(``kernels.engine.walk``, the same torch backend the plain versions
walk), with no kernel launched:

* **bijectivity**: the valid steps cover the blocked simplex ``T^m(n)``
  exactly once, every coordinate in range;
* **write-race freedom** under the port's write discipline, not the
  TPU's trash-tile parking: a Hopper block whose step is invalid returns
  before it writes (ROADMAP north star), so a walk writes the blocks of
  its valid steps and no two of them, in one launch or across the pieces
  or shards of one walk, may write the same block; and a shard writes
  only its ``owned_block_mask``, which the masks of the other shards of
  its fold must not overlap (the engine executor stitches by them).

The passes run the reference's matrix (``DEFAULT_MN``) over every
registered kind, resolved as a launch resolves it, the pieces of a
composite walk, and the ``SHARD_COUNTS``-way shard views of
``distributed.simplex_sharding``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .registry import Finding, LintContext, register_pass

__all__ = [
    "DEFAULT_MN",
    "SHARD_COUNTS",
    "eval_schedule_map",
    "check_schedule_bijectivity",
    "check_schedule_race",
    "check_shard_masks",
    "verified_schedules",
]

# (power-of-two n, other n) per dimension: the reference's matrix.
DEFAULT_MN: Dict[int, Tuple[int, int]] = {2: (8, 6), 3: (8, 6), 4: (4, 6)}
# Shard counts of the shard views at each (m, n).
SHARD_COUNTS: Tuple[int, ...] = (2, 3)


def eval_schedule_map(sched) -> Tuple[np.ndarray, np.ndarray]:
    """Every step of a walk: ``(coords, valid)``, ``(steps, m)`` int64
    math-order block coordinates and a ``(steps,)`` bool flag.

    Example:
        >>> from repro_torch.core.schedule import SimplexSchedule
        >>> coords, valid = eval_schedule_map(SimplexSchedule(2, 4, "bb"))
        >>> int(valid.sum())
        10
    """
    from ..kernels.engine import walk

    coords, valid = walk(sched, torch.device("cpu"))
    return coords.numpy(), valid.numpy()


def _domain_set(m: int, n: int) -> set:
    """The blocks of the domain: the inclusive lower triangle at m=2,
    ``sum < n`` beyond."""
    if m == 2:
        return {(x, y) for y in range(n) for x in range(y + 1)}
    from ..core.simplex import enumerate_simplex

    return set(map(tuple, enumerate_simplex(n, m)))


def _label(sched, m: int, n: int) -> str:
    return f"<semantic:schedule m={m} n={n} kind={getattr(sched, 'kind', '?')}>"


def check_schedule_bijectivity(sched, m: int, n: int,
                               pass_name: str = "schedule-bijectivity") -> List[Finding]:
    """Findings for a valid step out of range or off the domain, a block
    covered twice and blocks never covered."""
    coords, valid = eval_schedule_map(sched)
    where = _label(sched, m, n)
    live = coords[valid]
    oob = (live < 0) | (live >= n)
    if oob.any():
        step = int(np.nonzero(oob.any(axis=1))[0][0])
        return [Finding(pass_name, where, 0, f"out-of-bounds coordinate "
                        f"{tuple(live[step])} on a valid step (n={n})")]
    domain = _domain_set(m, n)
    seen: Dict[tuple, int] = {}
    for row in map(tuple, live.tolist()):
        seen[row] = seen.get(row, 0) + 1
    out = []
    for row, count in seen.items():
        if row not in domain:
            out.append(Finding(pass_name, where, 0,
                               f"valid step maps outside the simplex domain: {row}"))
        elif count > 1:
            out.append(Finding(pass_name, where, 0, f"block {row} covered {count} times "
                               "(the walk is not injective on its valid steps)"))
    missing = domain - set(seen)
    if missing:
        out.append(Finding(pass_name, where, 0, f"{len(missing)} domain blocks never "
                           f"visited, e.g. {sorted(missing)[:3]}"))
    return out


def check_schedule_race(sched, m: int, n: int,
                        pass_name: str = "write-race") -> List[Finding]:
    """Findings for two valid steps that write one block: the port's
    kernels write a valid step's block and nothing for an invalid one."""
    coords, valid = eval_schedule_map(sched)
    where = _label(sched, m, n)
    out = []
    first: Dict[tuple, int] = {}
    for step in np.nonzero(valid)[0].tolist():
        row = tuple(coords[step].tolist())
        if row in first:
            out.append(Finding(pass_name, where, 0, f"write race: grid steps {first[row]} "
                               f"and {step} both write block {row}"))
        else:
            first[row] = step
    return out


def check_shard_masks(shards: Sequence, m: int, n: int,
                      pass_name: str = "write-race") -> List[Finding]:
    """Findings for a shard whose valid steps write outside its
    ``owned_block_mask``, or leave a block of it unwritten, and for two
    shards of one fold whose masks overlap."""
    out = []
    owner = np.full((n,) * m, -1, dtype=np.int64)
    for i, shard in enumerate(shards):
        where = f"<semantic:shard {i}/{len(shards)} m={m} n={n}>"
        mask = np.asarray(shard.owned_block_mask(), dtype=bool)
        coords, valid = eval_schedule_map(shard)
        wrote = np.zeros_like(mask)
        live = coords[valid]
        wrote[tuple(live[:, m - 1 - j] for j in range(m))] = True  # array-axis order
        if (wrote & ~mask).any():
            out.append(Finding(pass_name, where, 0, f"writes {int((wrote & ~mask).sum())} "
                               "blocks outside its owned_block_mask"))
        if (mask & ~wrote).any():
            out.append(Finding(pass_name, where, 0, f"owns {int((mask & ~wrote).sum())} "
                               "blocks it never writes (the stitch would keep stale ones)"))
        clash = mask & (owner >= 0)
        if clash.any():
            other = int(owner[clash][0])
            out.append(Finding(pass_name, where, 0, f"owned_block_mask overlaps shard "
                               f"{other}'s on {int(clash.sum())} blocks"))
        owner[mask & (owner < 0)] = i
    return out


class _Union:
    """The walks of several views (pieces or shards) as one, so that the
    single-walk checks see a block two views both cover."""

    def __init__(self, views):
        self.views = views
        self.kind = f"{getattr(views[0], 'kind', '?')}[x{len(views)}]"
        self.m, self.n = views[0].m, views[0].n
        self.steps = sum(v.steps for v in views)
        self.grid = (self.steps,)
        self.prefetch = None

    def map(self, lin):
        """The views' walks, concatenated in order (``lin`` is every step)."""
        parts = [eval_schedule_map(v) for v in self.views]
        coords = np.concatenate([c for c, _ in parts])
        valid = np.concatenate([ok for _, ok in parts])
        idx = lin.numpy() if isinstance(lin, torch.Tensor) else np.asarray(lin)
        return tuple(torch.from_numpy(coords[idx, j]) for j in range(self.m)) + (
            torch.from_numpy(valid[idx]),)


def verified_schedules(m: int, n: int):
    """``(label, views)`` of the walks verified at one (m, n): every
    registered kind resolved as a launch resolves it, the pieces of the
    composite walk, and the ``SHARD_COUNTS``-way shard views of the
    ``table`` walk; the views of one label cover the domain together."""
    from ..core.schedule import SimplexSchedule, registered_kinds, resolve_kind
    from ..distributed.simplex_sharding import shard_schedules

    seen = set()
    for kind in registered_kinds(m):
        resolved = resolve_kind(m, n, kind)
        if resolved in seen:
            continue
        seen.add(resolved)
        try:
            sched = SimplexSchedule(m, n, resolved)
        except (ValueError, AssertionError):
            continue
        yield (f"{kind}->{resolved}" if resolved != kind else kind), [sched]
        if resolved == "composite":
            yield "composite-pieces", list(sched.split_pieces())
    base = SimplexSchedule(m, n, "table")
    for k in SHARD_COUNTS:
        yield f"shard(k={k})", list(shard_schedules(base, k))


def _views_findings(check, views, m: int, n: int) -> List[Finding]:
    return check(views[0] if len(views) == 1 else _Union(views), m, n)


def run_matrix(check, mn=None) -> Dict[Tuple[int, int, str], List[Finding]]:
    """``check``'s findings for every label of ``verified_schedules`` over
    the matrix ``mn`` (``DEFAULT_MN`` by default)."""
    out = {}
    for m, ns in (mn or DEFAULT_MN).items():
        for n in ns:
            for label, views in verified_schedules(m, n):
                out[(m, n, label)] = _views_findings(check, views, m, n)
    return out


@register_pass("schedule-bijectivity", "semantic",
               "every registered kind's valid steps cover the simplex exactly once")
def _bijectivity_pass(ctx: LintContext) -> List[Finding]:
    return [f for found in run_matrix(check_schedule_bijectivity).values() for f in found]


@register_pass("write-race", "semantic",
               "no two valid steps write one block; a shard writes only its own mask")
def _race_pass(ctx: LintContext) -> List[Finding]:
    from ..core.schedule import SimplexSchedule
    from ..distributed.simplex_sharding import shard_schedules

    out = [f for found in run_matrix(check_schedule_race).values() for f in found]
    for m, ns in DEFAULT_MN.items():
        for n in ns:
            for k in SHARD_COUNTS:
                out.extend(check_shard_masks(
                    shard_schedules(SimplexSchedule(m, n, "table"), k), m, n))
    return out
