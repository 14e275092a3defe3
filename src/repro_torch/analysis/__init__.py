"""``simplexlint`` for the port: static checks of its schedules, kernels
and house rules.

The port's counterpart of the JAX package's ``repro/analysis``: a pass
registry (``registry.py``) whose semantic passes replay the port's
schedule walks and shard views on the CPU (``schedule_passes.py``:
bijectivity and the port's write discipline) and check CA's declared
neighbourhood against what its plain version reads and what ``ca.cu``
stages (``halo_passes.py``), and whose AST passes hold the port's house
rules (``ast_passes.py``: no ``jax`` or ``repro`` import, no ``try`` that
falls back to a plain version, no environment switch of the device or the
route, no stale ``DESIGN.md`` section reference).  No kernel is launched.

Run it with ``python -m repro_torch.analysis.cli [--json]``.

Example:
    >>> from repro_torch.analysis import registered_passes
    >>> sorted(p in registered_passes() for p in
    ...        ("write-race", "schedule-bijectivity", "halo-conformance"))
    [True, True, True]
"""

from . import ast_passes, halo_passes, schedule_passes  # noqa: F401 (self-registration)
from .registry import (
    Finding,
    LintContext,
    Pass,
    findings_to_json,
    get_pass,
    register_pass,
    registered_passes,
    run_passes,
)

__all__ = [
    "Finding",
    "LintContext",
    "Pass",
    "findings_to_json",
    "get_pass",
    "register_pass",
    "registered_passes",
    "run_passes",
]
