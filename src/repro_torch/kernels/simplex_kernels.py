"""Deprecated per-(body, dimension) kernel entry points.

.. deprecated::
    Every function here is a thin shim over the dimension-generic
    ``SimplexKernel`` engine (``kernels/engine.py``, DESIGN.md §2.3),
    kept so that code written against the JAX package's
    ``kernels/simplex_kernels.py`` keeps working — each call emits a
    ``DeprecationWarning`` and delegates to the engine:

    ========================  =======================================
    legacy entry point        engine replacement
    ========================  =======================================
    ``map2d(nb, ...)``        ``engine.map_table(nb, m=2, ...)``
    ``accum2d(x, ...)``       ``engine.accum(x, ...)``
    ``edm2d(p, ...)``         ``engine.edm2d(p, ...)``
    ``ca2d(state, ...)``      ``engine.ca(state, ...)``
    ``accum3d(x, ...)``       ``engine.accum(x, ...)``
    ``ca3d(state, ...)``      ``engine.ca(state, ...)``
    ``accum_md(x, ...)``      ``engine.accum_md(x, ...)``
    ``grid_steps_2d(nb, k)``  ``engine.grid_steps(nb, k, m=2)``
    ``grid_steps_3d(nb, k)``  ``engine.grid_steps(nb, k, m=3)``
    ========================  =======================================

    The shims go to the engine, not to the frozen originals of
    ``kernels/legacy.py``: those stay independent of the engine, so that
    holding one against the other compares two implementations.  As in
    the JAX package the engine also serves the linear-grid kinds
    (``table`` / ``composite``) at m=2.  ``device`` takes the place of the
    reference's ``interpret``: None is the card, ``'cpu'`` the plain
    versions; the default ``kind`` is the reference's ``'auto'`` (``map2d``
    keeps ``'hmap'``).

New workloads should register a body with the engine instead of adding
functions here (see ``engine.register_body`` / DESIGN.md §2.3).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from . import engine

__all__ = [
    "map2d",
    "accum2d",
    "edm2d",
    "ca2d",
    "accum3d",
    "ca3d",
    "accum_md",
    "grid_steps_2d",
    "grid_steps_3d",
]


def _warn(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.kernels.simplex_kernels.{old} is deprecated; use "
        f"repro_torch.kernels.engine.{new} (the dimension-generic SimplexKernel "
        "engine) instead",
        DeprecationWarning,
        stacklevel=3,
    )


def map2d(nb: int, kind: str = "hmap", chunk: int = 128, device=None) -> torch.Tensor:
    """Deprecated: ``engine.map_table(nb, m=2, ...)`` — (steps, 3) int32
    (x, y, valid) rows of the 2-simplex schedule walk."""
    _warn("map2d", "map_table")
    return engine.map_table(nb, m=2, kind=kind, chunk=chunk, device=device)


def accum2d(x, rho: int = 8, kind: str = "auto", device=None) -> torch.Tensor:
    """Deprecated: ``engine.accum(x, ...)`` — +1 on the inclusive lower
    triangle of x (n x n, rho | n); x itself is not changed."""
    _warn("accum2d", "accum")
    return engine.accum(x, rho=rho, kind=kind, device=device)


def edm2d(p, rho: int = 8, kind: str = "auto", device=None) -> torch.Tensor:
    """Deprecated: ``engine.edm2d(p, ...)`` — ||p_i - p_j|| on the
    inclusive lower triangle, 0 elsewhere."""
    _warn("edm2d", "edm2d")
    return engine.edm2d(p, rho=rho, kind=kind, device=device)


def ca2d(state, rho: int = 8, kind: str = "auto", device=None) -> torch.Tensor:
    """Deprecated: ``engine.ca(state, ...)`` — one GoL step on the
    inclusive lower triangle (periodic underlying square)."""
    _warn("ca2d", "ca")
    return engine.ca(state, rho=rho, kind=kind, device=device)


def accum3d(x, rho: int = 4, kind: str = "auto", split: Optional[bool] = None,
            device=None) -> torch.Tensor:
    """Deprecated: ``engine.accum(x, ...)`` — +1 on T(n) = {x+y+z < n};
    axes (z, y, x); rho | n."""
    _warn("accum3d", "accum")
    return engine.accum(x, rho=rho, kind=kind, split=split, device=device)


def ca3d(state, rho: int = 4, kind: str = "auto", device=None) -> torch.Tensor:
    """Deprecated: ``engine.ca(state, ...)`` — one 26-neighbour GoL step
    on T(n), free boundaries."""
    _warn("ca3d", "ca")
    return engine.ca(state, rho=rho, kind=kind, device=device)


def accum_md(x, rho: int = 2, kind: str = "auto", split: Optional[bool] = None,
             device=None) -> torch.Tensor:
    """Deprecated: ``engine.accum_md(x, ...)`` — +1 on T(n) =
    {sum(coords) < n} for an m-cube input (m = x.ndim >= 3)."""
    _warn("accum_md", "accum_md")
    return engine.accum_md(x, rho=rho, kind=kind, split=split, device=device)


def grid_steps_2d(nb: int, kind: str) -> int:
    """Deprecated: ``engine.grid_steps(nb, kind, m=2)``."""
    _warn("grid_steps_2d", "grid_steps")
    return engine.grid_steps(nb, kind, m=2)


def grid_steps_3d(nb: int, kind: str) -> int:
    """Deprecated: ``engine.grid_steps(nb, kind, m=3)``."""
    _warn("grid_steps_3d", "grid_steps")
    return engine.grid_steps(nb, kind, m=3)
