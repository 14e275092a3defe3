"""AST passes: the port's house rules.

* ``no-jax-import``: nothing under ``src/repro_torch/``, nor
  ``chip_smoke.py``, imports ``jax`` (or ``jaxlib``) or the JAX package
  ``repro``; only the tests import both.
* ``no-plain-fallback``: no ``try`` whose handler calls a kernel's plain
  version (a name or attribute ``plain``, ``plain_`` or ``*_plain``): a
  CUDA tensor always launches the kernel, and a kernel that fails raises.
* ``no-env-device``: no environment variable selects the device or the
  route (a key naming a device, a backend, a route, the plain version or
  a fallback); dispatch follows the tensor (``kernels/policy.on_card``).
* ``design-xref``: every ``DESIGN.md §x[.y]`` the port's sources cite is
  a section of ``DESIGN.md`` (the reference's pass of that name).
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterator, List, Tuple

from .registry import Finding, LintContext, register_pass

__all__ = ["FORBIDDEN_IMPORTS", "ENV_SWITCH_RE", "design_sections"]

FORBIDDEN_IMPORTS = ("jax", "jaxlib", "repro")
# An environment key that would pick the device or the route.
ENV_SWITCH_RE = re.compile(r"DEVICE|CUDA|GPU|CPU|BACKEND|ROUTE|PLAIN|FALLBACK|INTERPRET")
_PLAIN_RE = re.compile(r"^(?:plain_?|\w+_plain)$")
_SECTION_RE = re.compile(r"^#{2,}\s+(§\d+(?:\.\d+)?)\b", re.MULTILINE)
_XREF_RE = re.compile(r"DESIGN\.md\s+(§\d+(?:\.\d+)?)")


def _sources(ctx: LintContext) -> List[pathlib.Path]:
    """The port's sources and ``chip_smoke.py`` where the root has one."""
    smoke = ctx.repo_root / "chip_smoke.py"
    return ctx.python_sources() + ([smoke] if smoke.exists() else [])


def _imports(tree: ast.Module) -> Iterator[Tuple[int, str]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@register_pass("no-jax-import", "ast",
               "the port and chip_smoke.py import neither jax nor the JAX package")
def _no_jax_import(ctx: LintContext) -> List[Finding]:
    out = []
    for py in _sources(ctx):
        for line, name in _imports(ctx.parsed(py)[1]):
            if name.split(".")[0] in FORBIDDEN_IMPORTS:
                out.append(Finding("no-jax-import", ctx.rel(py), line,
                                   f"imports {name}: the port runs without JAX and "
                                   "keeps its own copy of what it needs"))
    return out


def _callee(node: ast.Call) -> str:
    f = node.func
    return f.attr if isinstance(f, ast.Attribute) else f.id if isinstance(f, ast.Name) else ""


@register_pass("no-plain-fallback", "ast",
               "no try whose handler falls back to a kernel's plain version")
def _no_plain_fallback(ctx: LintContext) -> List[Finding]:
    out = []
    for py in ctx.python_sources():
        for node in ast.walk(ctx.parsed(py)[1]):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                for call in ast.walk(handler):
                    if isinstance(call, ast.Call) and _PLAIN_RE.match(_callee(call)):
                        out.append(Finding("no-plain-fallback", ctx.rel(py), call.lineno,
                                           f"an except clause calls {_callee(call)}: a "
                                           "kernel that fails must raise, not fall back"))
    return out


def _env_key(node: ast.AST) -> Tuple[bool, str]:
    """Whether ``node`` reads the environment, and the key when it is a
    string constant: ``os.environ[k]``, ``os.environ.get(k)``,
    ``os.getenv(k)``."""
    def const(x):
        return x.value if isinstance(x, ast.Constant) and isinstance(x.value, str) else ""

    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute) \
            and node.value.attr == "environ":
        return True, const(node.slice)
    if isinstance(node, ast.Call) and node.args:
        f = node.func
        if isinstance(f, ast.Attribute) and (
                f.attr == "getenv" or (f.attr in ("get", "setdefault", "pop")
                                       and isinstance(f.value, ast.Attribute)
                                       and f.value.attr == "environ")):
            return True, const(node.args[0])
    return False, ""


@register_pass("no-env-device", "ast",
               "no environment variable selects the device or the route")
def _no_env_device(ctx: LintContext) -> List[Finding]:
    out = []
    for py in ctx.python_sources():
        tree = ctx.parsed(py)[1]
        names = {t.id: n.value.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)
                 for t in n.targets if isinstance(t, ast.Name)}
        for node in ast.walk(tree):
            reads, key = _env_key(node)
            if not reads:
                continue
            if not key:  # a module constant holding the key
                arg = node.slice if isinstance(node, ast.Subscript) else node.args[0]
                key = names.get(arg.id, "") if isinstance(arg, ast.Name) else ""
            if ENV_SWITCH_RE.search(key.upper()):
                out.append(Finding("no-env-device", ctx.rel(py), node.lineno,
                                   f"reads {key}: the tensor's device picks the route "
                                   "(kernels/policy.on_card), no variable does"))
    return out


def design_sections(repo_root: pathlib.Path) -> set:
    """The ``§N`` / ``§N.M`` section anchors of ``DESIGN.md`` (none when
    it is absent)."""
    path = repo_root / "DESIGN.md"
    return set(_SECTION_RE.findall(path.read_text())) if path.exists() else set()


@register_pass("design-xref", "ast",
               "every 'DESIGN.md §x' the port cites is a section of DESIGN.md")
def _design_xref(ctx: LintContext) -> List[Finding]:
    secs = design_sections(ctx.repo_root)
    out = []
    for py in _sources(ctx):
        for i, line in enumerate(ctx.parsed(py)[0].splitlines(), start=1):
            for ref in _XREF_RE.findall(line):
                if ref not in secs:
                    out.append(Finding("design-xref", ctx.rel(py), i,
                                       f"stale cross-reference DESIGN.md {ref} "
                                       f"(existing sections: {sorted(secs)})"))
    return out
