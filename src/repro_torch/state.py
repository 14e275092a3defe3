"""The state this system carries across a run, handed to the port.

The system has no weights.  Its state is the domain array (ACCUM and
CA), the point set (EDM) and a schedule's host payload: the ``table``
kind's ``(steps, m)`` int32 table and the composite kind's piece list.
The JAX package holds these as numpy arrays and ``SimplexPiece`` lists;
``load_state`` checks them and returns the port's tensors on a device,
so that both packages can be fed the same state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .core.simplex import simplex_volume
from .core.trapezoids import SimplexPiece, pack_pieces
from .kernels.policy import resolve_device

__all__ = ["SimplexState", "load_state"]


@dataclass(frozen=True)
class SimplexState:
    """The port's tensors of one state (None where not given).

    Attributes:
        domain: ``(n,)*m`` domain array (ACCUM / CA).
        points: ``(n, d)`` float point set (EDM).
        table: ``(steps, m)`` int32 table of a ``table``-kind walk.
        pieces: packed int32 piece list of a composite walk, the layout
            of ``core.trapezoids.pack_pieces``.
    """

    domain: Optional[torch.Tensor] = None
    points: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None
    pieces: Optional[torch.Tensor] = None


def _numeric(a: np.ndarray, what: str) -> None:
    if not (np.issubdtype(a.dtype, np.integer) or np.issubdtype(a.dtype, np.floating)):
        raise ValueError(f"{what} must be integer or float, got {a.dtype}")


def load_state(m: int, *, domain=None, points=None, table=None, nb: Optional[int] = None,
               pieces: Optional[Sequence] = None, device=None) -> SimplexState:
    """Check numpy state and return it as the port's tensors on ``device``.

    Args:
        m: Simplex dimension the state belongs to.
        domain: ``(n,)*m`` numeric numpy array.
        points: ``(n, d)`` float numpy array.
        table: ``(V, m)`` int32 numpy table of the block simplex of side
            ``nb`` (V = ``simplex_volume(nb, m)``).
        nb: Block side of ``table`` (required with it).
        pieces: Composite pieces, each with ``.groups`` chains
            ``((dim, side, delta), ...)`` as ``decompose_simplex`` gives.
        device: Where the tensors go; None means the card.

    Returns:
        A ``SimplexState``.

    Raises:
        ValueError: on a wrong dtype or shape.
        RuntimeError: ``device`` is None and no CUDA device is present.

    Example:
        >>> s = load_state(2, domain=np.zeros((4, 4), np.int32), device="cpu")
        >>> s.domain.shape, s.points is None
        (torch.Size([4, 4]), True)
    """
    device = resolve_device(device)
    out = {}
    if domain is not None:
        domain = np.asarray(domain)
        _numeric(domain, "domain")
        n = domain.shape[0] if domain.ndim else 0
        if domain.shape != (n,) * m:
            raise ValueError(f"domain must be an m-cube {(n,) * m}, got {domain.shape}")
        out["domain"] = torch.from_numpy(np.ascontiguousarray(domain)).to(device)
    if points is not None:
        points = np.asarray(points)
        if points.ndim != 2 or not np.issubdtype(points.dtype, np.floating):
            raise ValueError(f"points must be a float (n, d) array, got "
                             f"{points.dtype} {points.shape}")
        out["points"] = torch.from_numpy(np.ascontiguousarray(points)).to(device)
    if table is not None:
        table = np.asarray(table)
        if nb is None:
            raise ValueError("a table needs its block side nb")
        want = (simplex_volume(nb, m), m)
        if table.dtype != np.int32 or table.shape != want:
            raise ValueError(f"table must be int32 {want}, got {table.dtype} {table.shape}")
        if table.min(initial=0) < 0 or table.max(initial=0) >= nb:
            raise ValueError(f"table coordinates must lie in [0, {nb})")
        out["table"] = torch.from_numpy(np.ascontiguousarray(table)).to(device)
    if pieces is not None:
        ported = [SimplexPiece(tuple(tuple(int(v) for v in g) for g in p.groups))
                  for p in pieces]
        out["pieces"] = torch.from_numpy(pack_pieces(ported, m)).to(device)
    return SimplexState(**out)
