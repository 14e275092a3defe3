"""The port's scheduling core: simplex maps and schedules, numpy or torch."""

from . import general_m, hmap, maps_baseline, schedule, simplex, trapezoids
from .schedule import (
    Schedule2D,
    SimplexSchedule,
    folded_causal_pairs,
    grid_steps,
    registered_kinds,
    resolve_kind,
)
from .simplex import simplex_volume, tet, tri
from .trapezoids import Trapezoid, decompose, total_grid_cells, trapezoid_map

__all__ = [
    "general_m",
    "hmap",
    "maps_baseline",
    "schedule",
    "simplex",
    "trapezoids",
    "Schedule2D",
    "Trapezoid",
    "SimplexSchedule",
    "folded_causal_pairs",
    "decompose",
    "grid_steps",
    "registered_kinds",
    "resolve_kind",
    "simplex_volume",
    "tet",
    "total_grid_cells",
    "trapezoid_map",
    "tri",
]
