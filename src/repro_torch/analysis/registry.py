"""Pass registry and finding model of the port's ``simplexlint``.

A pass is a named callable ``run(ctx) -> list[Finding]`` over a
``LintContext`` (the repository root, the source tree the AST passes scan
and a per-run cache of parsed sources).  Passes register themselves when
their module is imported (``register_pass``); the command line
(``analysis/cli.py``) and the tests run the same registry.  The finding
model and the JSON report keep the reference's shape
(``repro/analysis/registry.py``).  Two families: ``'ast'`` (source-tree
rules) and ``'semantic'`` (schedules and kernel bodies replayed on the
CPU).
"""

from __future__ import annotations

import ast
import json
import pathlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "LintContext",
    "Pass",
    "register_pass",
    "registered_passes",
    "get_pass",
    "run_passes",
    "findings_to_json",
]


@dataclass(frozen=True)
class Finding:
    """One violation a pass reports.

    Attributes:
        pass_name: Name of the reporting pass.
        path: Repository-relative file path, or a ``<semantic:...>``
            locator for a schedule or kernel finding with no source line.
        line: 1-based source line (0 for semantic findings).
        message: What is wrong.
        fixable: Whether a pass can rewrite it (none of the port's can).
    """

    pass_name: str
    path: str
    line: int
    message: str
    fixable: bool = False

    def format(self) -> str:
        """``path:line: [pass] message``, the command line's text row.

        Example:
            >>> Finding("write-race", "a.py", 3, "two writers").format()
            'a.py:3: [write-race] two writers'
        """
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.pass_name}] {self.message}"


@dataclass
class LintContext:
    """What a pass may inspect.

    Attributes:
        repo_root: Repository root (``DESIGN.md``, ``chip_smoke.py``).
        src_root: Python tree the AST passes scan (``src/repro_torch``).
        cache: Per-run scratch shared between passes (parsed sources).
    """

    repo_root: pathlib.Path
    src_root: pathlib.Path
    cache: Dict[str, object] = field(default_factory=dict)

    def python_sources(self) -> List[pathlib.Path]:
        """Sorted ``*.py`` files under ``src_root`` (cached)."""
        if "py_sources" not in self.cache:
            self.cache["py_sources"] = sorted(self.src_root.rglob("*.py"))
        return self.cache["py_sources"]

    def parsed(self, path: pathlib.Path) -> Tuple[str, ast.Module]:
        """The source text and ``ast.Module`` of ``path`` (cached)."""
        key = f"ast:{path}"
        if key not in self.cache:
            text = path.read_text()
            self.cache[key] = (text, ast.parse(text))
        return self.cache[key]

    def rel(self, path: pathlib.Path) -> str:
        """``path`` relative to the repository root, with forward slashes."""
        try:
            return path.relative_to(self.repo_root).as_posix()
        except ValueError:
            return str(path)


@dataclass(frozen=True)
class Pass:
    """A registered pass: its name, family (``'ast'`` or ``'semantic'``),
    ``run(ctx) -> list[Finding]`` and a one-line description."""

    name: str
    family: str
    run: Callable[[LintContext], List[Finding]]
    description: str


_PASSES: Dict[str, Pass] = {}


def register_pass(name: str, family: str, description: str):
    """A decorator that registers ``run(ctx) -> list[Finding]`` as the
    pass ``name`` and returns it unchanged.

    Raises:
        ValueError: an unknown family.

    Example:
        >>> import repro_torch.analysis  # the passes register on import
        >>> "write-race" in registered_passes()
        True
    """
    if family not in ("ast", "semantic"):
        raise ValueError(f"unknown pass family {family!r}")

    def deco(run):
        _PASSES[name] = Pass(name=name, family=family, run=run, description=description)
        return run

    return deco


def registered_passes() -> Tuple[str, ...]:
    """Sorted names of every registered pass."""
    return tuple(sorted(_PASSES))


def get_pass(name: str) -> Pass:
    """The pass ``name``.

    Raises:
        ValueError: no pass of that name.
    """
    if name not in _PASSES:
        raise ValueError(f"no pass named {name!r}; registered: {registered_passes()}")
    return _PASSES[name]


def run_passes(repo_root, src_root=None,
               passes: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the registry (or the named passes) and return their findings,
    in the order of the names.

    Args:
        repo_root: Repository root.
        src_root: Python tree of the AST passes; ``repo_root /
            "src" / "repro_torch"`` by default.
        passes: Pass names (default: all, sorted).
    """
    repo_root = pathlib.Path(repo_root).resolve()
    src_root = pathlib.Path(src_root) if src_root else repo_root / "src" / "repro_torch"
    out: List[Finding] = []
    for name in (list(passes) if passes is not None else list(registered_passes())):
        out.extend(get_pass(name).run(LintContext(repo_root=repo_root, src_root=src_root)))
    return out


def findings_to_json(findings: Sequence[Finding], passes: Sequence[str]) -> str:
    """The JSON report, the reference's schema (version 1): ``version``,
    ``passes``, ``counts`` by pass and ``findings``, whose rows mirror
    ``Finding``."""
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.pass_name] = counts.get(f.pass_name, 0) + 1
    return json.dumps({
        "version": 1,
        "passes": list(passes),
        "counts": counts,
        "findings": [{"pass": f.pass_name, "path": f.path, "line": f.line,
                      "message": f.message, "fixable": f.fixable} for f in findings],
    }, indent=2)
