"""Fused executors of simplex schedules as torch ops (DESIGN.md §5).

The counterpart of the JAX package's ``kernels/compiled.py``.  There the
whole schedule walk is traced into one XLA program (a vectorised
gather/mask/scatter over every grid step), the compiled path of hosts
whose Pallas backend can only interpret.  Its faithful port is the same
walk as torch tensor ops on the input's device, with no hand-written
kernel: ``executor='xla'`` of the engine's MAP and ACCUM bodies.

* ``schedule_coords_compiled(m, n, kind)`` — the schedule's map for every
  grid step at once; bit-equal to ``SimplexSchedule.table()``.
* ``accum2d_compiled`` / ``accum3d_compiled`` / ``accum_md_compiled`` —
  ACCUM over the whole walk; bit-equal to the engine's kernels (cells
  off the domain keep their input).

Every registered schedule visits each data tile at most once over its
valid steps, so the scatter writes each cell once.  The walk runs in
chunks of steps, which bounds the index tensors' memory and changes no
result.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.schedule import SimplexSchedule, resolve_kind
from .policy import resolve_device

__all__ = [
    "schedule_coords_compiled",
    "accum2d_compiled",
    "accum3d_compiled",
    "accum_md_compiled",
    "compiled_grid_shape",
]

# Elements of tile work per chunk of steps.
_CHUNK_ELEMS = 1 << 24


def _grid_unflatten(sched, lin):
    """lin -> one index tensor per grid axis (axis 0 fastest), as .table()."""
    ws = []
    for g in sched.grid:
        ws.append(lin % g)
        lin = lin // g
    return ws


def _walk(sched, device, per: int):
    """Per chunk of steps, ``(*coords, valid)`` of the schedule's map."""
    tab = sched.prefetch
    tab = () if tab is None else (torch.from_numpy(tab).to(device),)
    step = max(1, _CHUNK_ELEMS // per)
    for s0 in range(0, sched.steps, step):
        lin = torch.arange(s0, min(sched.steps, s0 + step), dtype=torch.int64,
                           device=device)
        yield sched.map(*_grid_unflatten(sched, lin), *tab)


def schedule_coords_compiled(m: int, n: int, kind: str, device=None) -> torch.Tensor:
    """Evaluate a schedule's map for every grid step as tensor ops.

    Args:
        m: Simplex dimension.
        n: Side length in tile units.
        kind: Exact registered kind (no ``'auto'``).
        device: Where to evaluate; None means the card.

    Returns:
        ``(steps, m+1)`` int32 tensor ``(*coords, valid)`` — bit-equal to
        ``SimplexSchedule.table()``.

    Example:
        >>> schedule_coords_compiled(2, 2, "hmap", device="cpu").tolist()
        [[0, 0, 1], [0, 1, 1], [1, 1, 1]]
    """
    device = resolve_device(device)
    sched = SimplexSchedule(m, n, kind)
    return torch.cat([torch.stack([c.to(torch.int32) for c in out], dim=1)
                      for out in _walk(sched, device, m + 1)])


def _resolve_2d_kind(nb: int, kind: str, device) -> str:
    kind = resolve_kind(2, nb, kind, device)
    if kind in ("table", "composite"):
        raise ValueError(f"accum2d_compiled uses the (w, h)-grid kinds; got {kind!r}")
    return kind


def _square(x: torch.Tensor, m: int, rho: int, name: str) -> int:
    n = x.shape[0] if x.ndim else 0
    if tuple(x.shape) != (n,) * m or rho < 1 or n % rho:
        raise ValueError(f"{name}: expected an {(n,) * m} array with rho={rho} dividing "
                         f"its side, got {tuple(x.shape)}")
    return n


def accum2d_compiled(x: torch.Tensor, rho: int = 8, kind: str = "auto") -> torch.Tensor:
    """ACCUM on the 2-simplex as one vectorised walk on ``x``'s device.

    Args:
        x: ``(n, n)`` tensor, ``rho | n``.
        rho: Square tile side.
        kind: ``hmap``/``rb``/``bb``/``auto`` (resolved for ``x``'s device).

    Returns:
        A new tensor: ``x`` with +1 on the inclusive lower triangle.

    Example:
        >>> accum2d_compiled(torch.zeros(4, 4, dtype=torch.int32), rho=2, kind="hmap").sum().item()
        10
    """
    n = _square(x, 2, rho, "accum2d_compiled")
    sched = SimplexSchedule(2, n // rho, _resolve_2d_kind(n // rho, kind, x.device))
    out = x.contiguous().clone()
    flat = out.view(-1)
    r = torch.arange(rho, device=x.device)
    for xb, yb, valid in _walk(sched, x.device, rho * rho):
        rows = yb[:, None, None] * rho + r[None, :, None]
        cols = xb[:, None, None] * rho + r[None, None, :]
        keep = (cols <= rows) & valid[:, None, None]
        off = (rows * n + cols)[keep]
        flat[off] += 1
    return out


def accum_md_compiled(x: torch.Tensor, rho: int = 2, kind: str = "auto") -> torch.Tensor:
    """General-m ACCUM (m = x.ndim >= 3) as one vectorised walk.

    Array axis j holds math coordinate ``x_{m-1-j}``; table kinds read
    their table from a tensor on ``x``'s device.

    Args:
        x: ``(n,)*m`` tensor, ``rho | n``.
        rho: Cubic tile side.
        kind: Schedule kind or ``'auto'`` (resolved for ``x``'s device).

    Returns:
        A new tensor: ``x`` with +1 on T(n) = {sum(coords) < n}.

    Example:
        >>> accum_md_compiled(torch.zeros((4,) * 3, dtype=torch.int32), kind="table").sum().item()
        20
    """
    m = x.ndim
    if m < 3:
        raise ValueError("accum_md_compiled serves m >= 3; use accum2d_compiled")
    n = _square(x, m, rho, "accum_md_compiled")
    nb = n // rho
    sched = SimplexSchedule(m, nb, resolve_kind(m, nb, kind, x.device))
    out = x.contiguous().clone()
    flat = out.view(-1)
    iota = torch.arange(rho, device=x.device)
    for res in _walk(sched, x.device, rho**m):
        coords, valid = res[:-1], res[-1]
        steps = valid.shape[0]
        off = torch.zeros((steps,) + (rho,) * m, dtype=torch.int64, device=x.device)
        total = torch.zeros_like(off)
        for ax, blk in enumerate(coords[::-1]):
            shape = [1] * (m + 1)
            shape[ax + 1] = rho
            g = blk.reshape((steps,) + (1,) * m) * rho + iota.reshape(shape)
            off = off * n + g
            total = total + g
        keep = (total < n) & valid.reshape((steps,) + (1,) * m)
        flat[off[keep]] += 1
    return out


def accum3d_compiled(x: torch.Tensor, rho: int = 4, kind: str = "auto") -> torch.Tensor:
    """ACCUM3D — the m=3 instance of ``accum_md_compiled``; axes (z, y, x).

    Example:
        >>> accum3d_compiled(torch.zeros((8,) * 3, dtype=torch.int32), kind="bb").sum().item()
        120
    """
    if x.ndim != 3:
        raise ValueError(f"accum3d_compiled takes an (n, n, n) array, got {tuple(x.shape)}")
    return accum_md_compiled(x, rho=rho, kind=kind)


def compiled_grid_shape(m: int, n: int, kind: str, device=None) -> Tuple[int, ...]:
    """Grid of the schedule a fused executor walks (inspection).

    Example:
        >>> compiled_grid_shape(2, 8, "hmap")
        (4, 9)
    """
    return SimplexSchedule(m, n, resolve_kind(m, n, kind, device)).grid
