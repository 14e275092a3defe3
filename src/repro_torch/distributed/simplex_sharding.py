"""Multi-device simplex sharding with skew control (DESIGN.md §7).

The paper's map H wins on one device by never launching the dead half
of the bounding box.  Across devices the same waste reappears as load
skew: slicing an m-simplex into equal-thickness slabs along one axis
gives the base slab up to m x the block volume of the apex slab.  The
fix partitions the *schedule's step list* (the parallel space, which
enumerates exactly the live blocks) instead of the bounding geometry.

``fold_partition`` folds the step list end over end (step 0, step S-1,
step 1, step S-2, ...) and deals it into k contiguous chunks of the
folded order.  Each chunk unfolds to at most two contiguous ranges of
the original order, one near the apex and one near the base, and its
step count stays within one of ``S/k``.  ``shard_skew`` (max/mean shard
block volume) is therefore at most ``1 + k/S``; ``slab_skew`` gives the
naive slab split's, about m.

``ShardSchedule`` is a shard as a launchable schedule: the ``.grid`` /
``.steps`` / ``.map`` / ``.prefetch`` surface of ``SimplexSchedule``
and a ``device_descriptor`` that reuses the base walk's (its table or
pieces stay where they are) with the launch slots of
``core.schedule.launch_header`` set.  So
``SimplexKernel(body, m, schedule=shard)`` launches exactly the shard's
blocks through the hand-written MAP, ACCUM, EDM and CA kernels, whose
device map (``kernels/csrc/simplex_maps.cuh``) turns a shard-local step
into the base step before it decodes it.

How the reference's single-controller JAX maps onto PyTorch:

* ``executor='engine'`` stays one process.  Each shard is one CA kernel
  launch over its ``ShardSchedule``, placed round-robin over the list of
  torch devices the caller passes as ``devices=`` (the reference's
  ``jax.device_put`` onto the mesh's devices; on one card the list is
  ``[cuda:0]``).  Every shard reads the same input generation and the
  output is stitched from the disjoint per-shard ownership masks, kept
  at block granularity and broadcast over the ``(nb, rho)*m`` view.
* ``executor='spmd'`` is a program every rank of a ``torch.distributed``
  group runs.  ``shard_mesh(k, axis)`` is ``init_device_mesh`` over the
  group (world size k); ``shard_state`` is ``distribute_tensor(state,
  mesh, [Shard(0)])``, the reference's axis-0 ``NamedSharding``; the
  ``ppermute`` of one seam plane each way is point-to-point
  (``batch_isend_irecv``) with the ranks ``(r +- 1) mod k``, a local copy
  where k = 1; boundaries are periodic at m=2 and zeros at the ends at
  m >= 3.  The output keeps the sharded layout (a ``DTensor``;
  ``full_tensor()`` gathers it).  The backend follows the tensors'
  device: NCCL for CUDA, gloo for the CPU, and a mesh refuses the other.

Run ``python -m repro_torch.examples.simplex_ca --devices k`` for the
end-to-end story: a long sharded CA that checkpoints through
``checkpoint/checkpointing.py`` and survives a simulated worker loss
through ``distributed.fault_tolerance.watchdog_restart``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from ..core.schedule import DeviceDescriptor, SimplexSchedule, launch_header, resolve_kind
from ..core.simplex import simplex_volume
from ..kernels.engine import SimplexKernel, default_rho
from ..kernels.policy import resolve_device

__all__ = [
    "StepShard",
    "ShardSchedule",
    "fold_partition",
    "shard_schedules",
    "shard_skew",
    "slab_skew",
    "shard_mesh",
    "shard_state",
    "ShardedSimplexCA",
    "sharded_ca",
]


# ---------------------------------------------------------------------------
# partition construction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StepShard:
    """One shard of a folded step-list partition.

    Attributes:
        index: Shard number in ``[0, k)``.
        k: Total shard count of the partition.
        ranges: Up to two ``(start, stop)`` half-open ranges of the base
            schedule's step order: the apex-side and base-side runs the
            fold pairs together (merged when they touch).
    """

    index: int
    k: int
    ranges: Tuple[Tuple[int, int], ...]

    @property
    def steps(self) -> int:
        """Total steps (block volume) this shard owns."""
        return sum(b - a for a, b in self.ranges)


def fold_partition(n_steps: int, k: int) -> Tuple[StepShard, ...]:
    """Fold a step list end over end into k balanced shards.

    The folded order visits steps ``0, S-1, 1, S-2, ...`` and is dealt
    into k contiguous chunks whose sizes differ by at most one; each
    chunk unfolds to one range near each end of the original order.

    Args:
        n_steps: Length S of the step list to partition.
        k: Shard count, ``1 <= k <= n_steps``.

    Returns:
        Tuple of k ``StepShard``; together a disjoint cover of
        ``range(n_steps)``.

    Example:
        >>> [s.ranges for s in fold_partition(6, 3)]
        [((0, 1), (5, 6)), ((1, 2), (4, 5)), ((2, 4),)]
    """
    if k < 1 or k > n_steps:
        raise ValueError(f"need 1 <= k <= n_steps, got k={k}, n_steps={n_steps}")
    base, rem = divmod(n_steps, k)
    shards = []
    p0 = 0
    for s in range(k):
        p1 = p0 + base + (1 if s < rem else 0)
        front = ((p0 + 1) // 2, (p1 + 1) // 2)
        back = (n_steps - p1 // 2, n_steps - p0 // 2)
        ranges = tuple((a, b) for a, b in (front, back) if b > a)
        if len(ranges) == 2 and ranges[0][1] == ranges[1][0]:
            ranges = ((ranges[0][0], ranges[1][1]),)
        shards.append(StepShard(index=s, k=k, ranges=ranges))
        p0 = p1
    return tuple(shards)


def shard_skew(schedule, k: int) -> float:
    """Max/mean shard block volume of the folded k-way partition.

    Args:
        schedule: Any schedule (only ``.steps`` is read).
        k: Shard count.

    Returns:
        ``max(shard steps) / mean(shard steps)`` over the k shards.

    Example:
        >>> shard_skew(SimplexSchedule(3, 8, "table"), 4)  # 120 = 4*30
        1.0
    """
    sizes = [s.steps for s in fold_partition(schedule.steps, k)]
    return max(sizes) / (sum(sizes) / len(sizes))


def slab_skew(m: int, nb: int, k: int) -> float:
    """Block-volume skew of the naive equal-thickness axis-0 slab split.

    Layer ``l`` of the blocked m-simplex holds ``l+1`` blocks at m=2 and
    ``V^{m-1}(nb - l)`` blocks at m >= 3.

    Args:
        m: Simplex dimension.
        nb: Tile (block) count per side.
        k: Slab count, ``1 <= k <= nb``.

    Returns:
        ``max(slab volume) / mean(slab volume)`` over the k slabs.

    Example:
        >>> round(slab_skew(3, 8, 4), 3)   # base slab 64 against a mean of 30
        2.133
    """
    if k < 1 or k > nb:
        raise ValueError(f"need 1 <= k <= nb, got k={k}, nb={nb}")
    if m == 2:
        vols = [lo + 1 for lo in range(nb)]
    else:
        vols = [simplex_volume(nb - lo, m - 1) for lo in range(nb)]
    base, rem = divmod(nb, k)
    sums, lo = [], 0
    for s in range(k):
        hi = lo + base + (1 if s < rem else 0)
        sums.append(sum(vols[lo:hi]))
        lo = hi
    return max(sums) / (sum(sums) / len(sums))


# ---------------------------------------------------------------------------
# shard schedules: the engine-facing surface
# ---------------------------------------------------------------------------


class ShardSchedule:
    """A shard of a base schedule, exposed as a launchable schedule.

    ``.map`` turns a shard-local linear index into the base step order
    (piecewise over the <= 2 ranges), then into the base grid's axes,
    and calls the base map; it takes numpy arrays or torch tensors.
    ``.device_descriptor`` is the base's descriptor with the launch
    slots set, its device payload shared with the base.

    Example:
        >>> base = SimplexSchedule(3, 4, "table")
        >>> shards = shard_schedules(base, 4)
        >>> [s.steps for s in shards]
        [5, 5, 5, 5]
        >>> tabs = np.concatenate([s.table() for s in shards])
        >>> sorted(map(tuple, tabs)) == sorted(map(tuple, base.table()))
        True
    """

    kind = "shard"

    def __init__(self, base: SimplexSchedule, shard: StepShard):
        if shard.steps < 1:
            raise ValueError(f"empty shard {shard.index} of {shard.k}")
        self.base = base
        self.shard = shard
        self.m = base.m
        self.n = base.n
        self.grid = (shard.steps,)
        self.steps = shard.steps
        self.useful = shard.steps
        self.ranges = shard.ranges
        self._desc_cache: Dict[str, DeviceDescriptor] = {}

    @property
    def prefetch(self):
        """The base schedule's table (table kinds), else None."""
        return self.base.prefetch

    def _global(self, lin):
        """Shard-local linear index -> base step-order index."""
        (a0, b0) = self.ranges[0]
        if len(self.ranges) == 1:
            return a0 + lin
        (a1, _) = self.ranges[1]
        l0 = b0 - a0
        where = torch.where if isinstance(lin, torch.Tensor) else np.where
        return where(lin < l0, a0 + lin, a1 + (lin - l0))

    def map(self, lin, *prefetch):
        """Shard-local index -> ``(*coords, valid)`` of the base walk.

        Args:
            lin: Linear index array or tensor in ``[0, self.steps)``.
            *prefetch: The base's table, of the same backend, for table
                kinds.

        Returns:
            The base schedule's ``(*coords, valid)`` at the mapped step.
        """
        g = self._global(lin)
        ws, rem = [], g
        for gdim in self.base.grid:
            ws.append(rem % gdim)
            rem = rem // gdim
        return self.base.map(*ws, *prefetch)

    def table(self) -> np.ndarray:
        """Host-side ``(steps, m+1)`` walk table of this shard only."""
        lin = np.arange(self.steps, dtype=np.int64)
        if self.prefetch is not None:
            out = self.map(lin, self.prefetch)
        else:
            out = self.map(lin)
        cols = [np.asarray(c) for c in out[:-1]]
        cols.append(np.asarray(out[-1]).astype(np.int64))
        return np.stack(cols, axis=1).astype(np.int32)

    def owned_block_mask(self) -> np.ndarray:
        """Boolean ``(nb,)*m`` mask of the blocks this shard owns.

        Valid steps only, in array-axis order: the stitching mask of the
        engine executor.  Host-side, O(shard steps).
        """
        tab = self.table()
        ok = tab[:, -1] != 0
        coords = tab[ok, : self.m]
        mask = np.zeros((self.n,) * self.m, dtype=bool)
        # table columns are math-order coords; array axis 0 is the last
        mask[tuple(coords[:, self.m - 1 - j] for j in range(self.m))] = True
        return mask

    def device_descriptor(self, device) -> DeviceDescriptor:
        """The base's descriptor launching only this shard (cached).

        Args:
            device: Where the base's payload (table or pieces) lives.

        Returns:
            A ``DeviceDescriptor`` whose ``data`` is the base's own.
        """
        key = str(torch.device(device))
        if key not in self._desc_cache:
            desc = self.base.device_descriptor(device)
            self._desc_cache[key] = DeviceDescriptor(
                launch_header(desc.header, self.ranges), desc.data)
        return self._desc_cache[key]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"ShardSchedule({self.shard.index}/{self.shard.k}, "
            f"m={self.m}, n={self.n}, ranges={self.ranges}, "
            f"base={self.base.kind!r})"
        )


def shard_schedules(base: SimplexSchedule, k: int) -> Tuple[ShardSchedule, ...]:
    """Fold a schedule into k engine-launchable shard schedules.

    Args:
        base: The schedule to partition (any registered kind).
        k: Shard count, ``1 <= k <= base.steps``.

    Returns:
        k ``ShardSchedule`` whose step sets disjointly cover the base walk.

    Example:
        >>> subs = shard_schedules(SimplexSchedule(2, 16, "hmap"), 8)
        >>> sum(s.steps for s in subs), max(s.steps for s in subs)
        (136, 17)
    """
    return tuple(ShardSchedule(base, s) for s in fold_partition(base.steps, k))


# ---------------------------------------------------------------------------
# mesh / layout helpers
# ---------------------------------------------------------------------------

# The backend a mesh of each device type runs its collectives on.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _group_backend(device_type: str) -> str:
    """The default group's backend for ``device_type`` tensors."""
    name = dist.get_backend()
    if ":" not in name:
        return name
    return dict(pair.split(":") for pair in name.split(",")).get(device_type, "")


def shard_mesh(k: int, axis: str = "shard", device=None):
    """A 1-D device mesh of size k over the ranks of the default group.

    Args:
        k: Rank count; the initialised default group's world size.
        axis: Mesh axis name.
        device: The ranks' device type: None for the card (NCCL), or
            ``'cpu'`` (gloo).

    Returns:
        ``torch.distributed.device_mesh.DeviceMesh`` with one named axis.

    Raises:
        ValueError: no group is initialised, its world size is not k, or
            its backend is not the device's (NCCL for CUDA, gloo for the
            CPU: there is no fallback from one to the other).
    """
    device_type = resolve_device(device).type
    if device_type not in BACKENDS:
        raise ValueError(f"no collective backend for {device_type} tensors")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"need a process group of {k} ranks; call "
            "torch.distributed.init_process_group first"
        )
    world = dist.get_world_size()
    if world != k:
        raise ValueError(f"need {k} ranks, found a group of {world}")
    backend = _group_backend(device_type)
    if backend != BACKENDS[device_type]:
        raise ValueError(
            f"{device_type} tensors take the {BACKENDS[device_type]} backend, "
            f"the group runs {backend or 'none for them'}"
        )
    return init_device_mesh(device_type, (k,), mesh_dim_names=(axis,))


def shard_state(state, mesh, axis: str = "shard"):
    """Place a domain array in the axis-0 slab layout over ``mesh``.

    Args:
        state: ``(n,)*m`` domain array or tensor, the same on every rank,
            ``n`` divisible by the mesh axis size.
        mesh: Mesh from ``shard_mesh``.
        axis: Mesh axis name to shard axis 0 over.

    Returns:
        A ``DTensor`` placed ``[Shard(0)]`` on the mesh's device type.
    """
    k = mesh.size(mesh.mesh_dim_names.index(axis))
    state = torch.as_tensor(state)
    if state.shape[0] % k != 0:
        raise ValueError(f"axis 0 ({state.shape[0]}) must divide over {k} devices")
    return distribute_tensor(state.contiguous(), mesh, [Shard(0)])


# ---------------------------------------------------------------------------
# sharded CA execution
# ---------------------------------------------------------------------------


class ShardedSimplexCA:
    """k-way sharded CA stepping, bit-equal to the single-device engine.

    ``executor='engine'``: each shard is one ``SimplexKernel('ca', ...)``
    launch over its ``ShardSchedule`` on ``devices[i % len(devices)]``;
    every shard reads the same input generation (a seam's halo is a
    neighbour fetch from a tile another shard owns), and the output is
    stitched from the disjoint ownership masks: the composition equals
    one fused launch bit for bit.

    ``executor='spmd'``: every rank of ``mesh`` steps its axis-0 slab
    of the state with torch ops, after one seam plane each way travels
    point to point, under true-coordinate domain masking (free
    boundaries at m >= 3, a periodic wrap at m=2: the engine's CA
    conventions).

    Args:
        m: Simplex dimension (>= 2).
        n: Domain side length in elements.
        k: Shard count.
        rho: Tile side of the engine executor (default
            ``engine.default_rho(m)``).
        kind: Base schedule kind (resolved through ``resolve_kind``).
        devices: Torch devices of the engine executor's shard launches,
            round-robin; None is the card.  The state and the stitched
            output live on the first.
        mesh: Mesh from ``shard_mesh`` for the SPMD executor.
        axis: The mesh's axis name.
    """

    def __init__(self, m: int, n: int, k: int, *, rho: Optional[int] = None,
                 kind: str = "hmap", devices: Optional[Sequence] = None, mesh=None,
                 axis: str = "shard"):
        self.m, self.n, self.k = m, n, k
        self.rho = default_rho(m) if rho is None else rho
        if n % self.rho != 0:
            raise ValueError(f"rho={self.rho} must divide n={n}")
        self.nb = n // self.rho
        self.devices = None if devices is None else [torch.device(d) for d in devices]
        home = None if self.devices is None else self.devices[0]
        self.kind = resolve_kind(m, self.nb, kind, home)
        self.mesh = mesh
        self.axis = axis
        self.base = SimplexSchedule(m, self.nb, self.kind)
        self.shards = shard_schedules(self.base, k)
        self._kernels = None  # per-shard launchers, built on the first engine step
        self._masks: Dict[str, list] = {}  # per device: block ownership masks

    # -- engine executor ---------------------------------------------------

    def _placement(self):
        if self._kernels is None:
            if self.devices is None:
                self.devices = [resolve_device(None)]
            self._kernels = [
                SimplexKernel("ca", self.m, rho=self.rho, kind=self.kind, schedule=sh,
                              device=self.devices[i % len(self.devices)])
                for i, sh in enumerate(self.shards)
            ]
        return self.devices[0], self._kernels

    def ownership_masks(self, device) -> list:
        """Each shard's ``(nb, 1)*m`` block ownership mask on ``device``,
        ready to broadcast over the state's ``(nb, rho)*m`` view."""
        key = str(torch.device(device))
        if key not in self._masks:
            shape = sum(((self.nb, 1) for _ in range(self.m)), ())
            self._masks[key] = [
                torch.from_numpy(sh.owned_block_mask()).reshape(shape).to(device)
                for sh in self.shards
            ]
        return self._masks[key]

    def shard_outputs(self, state) -> list:
        """Every shard's engine launch on ``state``, each on its device."""
        home, kernels = self._placement()
        state = torch.as_tensor(state, device=home)
        return [kern(state.to(kern.device)) for kern in kernels]

    def stitch(self, state, outs) -> torch.Tensor:
        """The next generation: each shard's owned blocks from its output,
        the rest of ``state`` (off the domain) kept."""
        home, _ = self._placement()
        state = torch.as_tensor(state, device=home)
        view = sum(((self.nb, self.rho) for _ in range(self.m)), ())
        out = state.view(view)
        for y, mask in zip(outs, self.ownership_masks(home)):
            out = torch.where(mask, y.to(home).view(view), out)
        return out.reshape(state.shape)

    def step_engine(self, state) -> torch.Tensor:
        """One CA generation through per-shard engine launches + stitching."""
        return self.stitch(state, self.shard_outputs(state))

    # -- SPMD executor -----------------------------------------------------

    def step_spmd(self, state):
        """One CA generation on every rank of the mesh.

        ``state`` may be the same ``(n,)*m`` tensor on every rank or a
        ``DTensor`` already in the slab layout; the output keeps the
        layout.
        """
        if self.mesh is None:
            raise ValueError("executor='spmd' needs a mesh (shard_mesh(k))")
        if self.n % self.k != 0:
            raise ValueError(
                f"spmd executor slabs elements: n={self.n} must divide over k={self.k}"
            )
        size = self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))
        if size != self.k:
            raise ValueError(f"the mesh axis {self.axis!r} has {size} ranks, not k={self.k}")
        if not isinstance(state, DTensor):
            state = shard_state(state, self.mesh, self.axis)
        fn = _spmd_step_fn(self.m, self.n, self.k, self.mesh, self.axis)
        out = fn(state.to_local())
        return DTensor.from_local(out, self.mesh, [Shard(0)], run_check=False,
                                  shape=state.shape, stride=state.stride())

    def step(self, state, executor: str = "engine"):
        """One CA generation with the chosen executor."""
        if executor == "engine":
            return self.step_engine(state)
        if executor == "spmd":
            return self.step_spmd(state)
        raise ValueError(f"unknown executor {executor!r}")

    def run(self, state, steps: int, executor: str = "engine"):
        """``steps`` generations from ``state``; returns the final one."""
        for _ in range(steps):
            state = self.step(state, executor=executor)
        return state


def slab_mask(m: int, n: int, start: int, slab: int, device) -> torch.Tensor:
    """The domain mask of rows ``[start, start + slab)`` of an ``(n,)*m``
    state in true coordinates: ``{col <= row}`` at m=2, ``{sum < n}``
    beyond.

    Example:
        >>> slab_mask(2, 4, 2, 2, "cpu").int().tolist()
        [[1, 1, 1, 0], [1, 1, 1, 1]]
    """
    shape = [1] * m
    coords = []
    for ax in range(m):
        c = torch.arange(n if ax else slab, device=device) + (start if ax == 0 else 0)
        shape[ax] = -1
        coords.append(c.view(shape))
        shape[ax] = 1
    if m == 2:
        return coords[1] <= coords[0]
    total = coords[0]
    for c in coords[1:]:
        total = total + c
    return total < n


def slab_step(local: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """One CA generation of an axis-0 slab, given its seam planes.

    Args:
        local: ``(slab, n, ...)`` rows of the state.
        up: ``(1, n, ...)`` masked plane before the slab (zeros at a free
            boundary).
        down: ``(1, n, ...)`` masked plane after it.
        mask: ``slab_mask`` of the slab.

    Returns:
        The slab's next generation; off-domain cells keep their input.
    """
    m = local.ndim
    periodic = m == 2
    s = torch.where(mask, local, 0)
    padded = local.new_zeros(tuple(d + 2 for d in local.shape))
    inner = (slice(1, -1),) * (m - 1)
    padded[(slice(1, -1),) + inner] = s
    padded[(slice(0, 1),) + inner] = up
    padded[(slice(-1, None),) + inner] = down
    if periodic:  # the other axes wrap as well (m=2 has one)
        padded[:, 0] = padded[:, -2]
        padded[:, -1] = padded[:, 1]
    neigh = torch.zeros_like(s)
    for shift in itertools.product(range(3), repeat=m):
        if all(d == 1 for d in shift):
            continue
        neigh += padded[tuple(slice(d, d + dim) for d, dim in zip(shift, s.shape))]
    born = (s == 0) & (neigh == 3)
    survive = (s == 1) & ((neigh == 2) | (neigh == 3))
    return torch.where(mask, (born | survive).to(local.dtype), local)


class _SpmdStep:
    """The SPMD step of one (m, n, k, axis, group): this rank's slab mask
    and its seam peers."""

    def __init__(self, m: int, n: int, k: int, mesh, axis: str):
        self.m, self.n, self.k = m, n, k
        self.slab = n // k
        dim = mesh.mesh_dim_names.index(axis)
        self.idx = mesh.get_local_rank(dim)
        self.group = mesh.get_group(dim)
        ranks = dist.get_process_group_ranks(self.group)
        self.next = ranks[(self.idx + 1) % k]
        self.prev = ranks[(self.idx - 1) % k]
        self.periodic = m == 2
        self._mask: Dict[str, torch.Tensor] = {}

    def seams(self, first: torch.Tensor, last: torch.Tensor):
        """``(up, down)`` from this rank's masked ``first`` and ``last``
        planes: the previous rank's last plane and the next rank's first,
        zeros across a free boundary."""
        k, idx, periodic = self.k, self.idx, self.periodic
        if k == 1:  # a rank cannot send to itself: the wrap is a copy
            if periodic:
                return last, first
            return torch.zeros_like(first), torch.zeros_like(first)
        up, down = torch.zeros_like(first), torch.zeros_like(first)
        ops = []
        # one order on every rank, so each pair's messages match in turn
        if periodic or idx < k - 1:
            ops.append(dist.P2POp(dist.isend, last, self.next, self.group, 0))
        if periodic or idx > 0:
            ops.append(dist.P2POp(dist.isend, first, self.prev, self.group, 1))
        if periodic or idx > 0:
            ops.append(dist.P2POp(dist.irecv, up, self.prev, self.group, 0))
        if periodic or idx < k - 1:
            ops.append(dist.P2POp(dist.irecv, down, self.next, self.group, 1))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return up, down

    def __call__(self, local: torch.Tensor) -> torch.Tensor:
        key = str(local.device)
        if key not in self._mask:
            self._mask[key] = slab_mask(self.m, self.n, self.idx * self.slab, self.slab,
                                        local.device)
        mask = self._mask[key]
        up, down = self.seams(torch.where(mask[:1], local[:1], 0),
                              torch.where(mask[-1:], local[-1:], 0))
        return slab_step(local, up, down, mask)


_SPMD_CACHE: Dict[tuple, _SpmdStep] = {}


def _spmd_step_fn(m: int, n: int, k: int, mesh, axis: str) -> _SpmdStep:
    """Build (and cache) the SPMD CA step for (m, n, k, axis, group)."""
    dim = mesh.mesh_dim_names.index(axis)
    key = (m, n, k, axis, tuple(dist.get_process_group_ranks(mesh.get_group(dim))),
           mesh.device_type)
    if key not in _SPMD_CACHE:
        _SPMD_CACHE[key] = _SpmdStep(m, n, k, mesh, axis)
    return _SPMD_CACHE[key]


def sharded_ca(state, k: int, steps: int = 1, *, rho: Optional[int] = None,
               kind: str = "hmap", devices: Optional[Sequence] = None, mesh=None,
               executor: str = "engine"):
    """Run ``steps`` sharded CA generations on an ``(n,)*m`` state.

    Bit-equal to ``steps`` applications of the single-device engine CA
    (``kernels.engine.ca`` / ``ca_md``).

    Args:
        state: ``(n,)*m`` 0/1 array or tensor (m = state.ndim >= 2).
        k: Shard count.
        steps: Generations to run.
        rho: Engine tile side (engine executor).
        kind: Base schedule kind.
        devices: Devices of the engine executor's shards (None: the card).
        mesh: Mesh from ``shard_mesh`` (SPMD executor).
        executor: ``'engine'`` or ``'spmd'``.

    Returns:
        The final generation: a tensor on ``devices[0]`` (engine), or a
        ``DTensor`` in the slab layout (SPMD; ``.full_tensor()`` gathers).

    Example:
        >>> s = torch.zeros(8, 8, dtype=torch.int32)
        >>> s[5, 3] = s[5, 4] = s[5, 5] = 1  # a blinker
        >>> out = sharded_ca(s, 4, rho=2, devices=["cpu"])
        >>> out[4:7, 4].tolist()
        [1, 1, 1]
    """
    state = torch.as_tensor(state)
    runner = ShardedSimplexCA(state.ndim, state.shape[0], k, rho=rho, kind=kind,
                              devices=devices, mesh=mesh)
    return runner.run(state, steps, executor=executor)
