"""Quickstart: the paper's H map, its schedules and the kernels on them.

The port's counterpart of the JAX package's ``examples/quickstart.py``,
with its sections: the H coverage grid; ``SimplexSchedule`` steps and
waste per m; the composite path for any n; ACCUM, EDM and m=4 ACCUM
against their oracles; the folded flash forward against dense attention.
Every check raises ``ExampleCheckFailed`` (so the run exits non-zero)
instead of printing ``False``.  The kernels run on the card unless
``--device cpu`` is given (their plain versions).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..core import SimplexSchedule, registered_kinds, resolve_kind, tri
from ..core.hmap import hmap2_full
from ..kernels import ops
from ..kernels import ref as R
from ..kernels.flash_attention import flash_grid_steps
from ..kernels.policy import resolve_device

__all__ = ["ExampleCheckFailed", "check", "main"]

# The kernels' gates against their oracles (chip_smoke.py's against the
# plain versions): EDM and float32 flash are float32-accurate on 3xTF32.
EDM_TOL = (1e-5, 1e-5)  # atol, and rtol of max |want|
FLASH_TOL = (2e-5, 2e-5)


class ExampleCheckFailed(AssertionError):
    """A quickstart or serve check did not hold."""


def check(ok: bool, what: str) -> None:
    """Print ``what`` and raise ``ExampleCheckFailed`` unless ``ok``."""
    print(f"  {what}: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise ExampleCheckFailed(what)


def _section(title: str) -> None:
    print()
    print("=" * 64)
    print(title)
    print("=" * 64)


def coverage(n_blocks: int = 16) -> None:
    """1. The H grid covers the lower triangle's tiles once each."""
    _section("1. The block-space map H (paper Eq. 14-16 + zero-waste diagonal)")
    w, h = n_blocks // 2, n_blocks + 1
    print(f"super-orthotope grid: {w} x {h} = {w * h} blocks "
          f"== tri({n_blocks}) = {tri(n_blocks)} lower-triangle tiles")
    wy, wx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x, y = hmap2_full(wx.ravel(), wy.ravel(), n_blocks)
    hits = np.zeros((n_blocks, n_blocks), dtype=int)
    np.add.at(hits, (np.asarray(y), np.asarray(x)), 1)
    print("covered tiles (# = exactly once):")
    for row in hits:
        print(" ", "".join("#" if c == 1 else ("." if c == 0 else "!") for c in row))
    check(bool((hits == np.tril(np.ones_like(hits))).all()),
          f"every one of the {tri(n_blocks)} tiles covered exactly once")


def schedules() -> None:
    """2. Steps and waste of every m's schedules."""
    _section("2. One scheduling API for every dimension: SimplexSchedule")
    print("  SimplexSchedule(m, n, kind) -> .grid/.steps/.map/.waste()")
    for m in (2, 3, 4):
        print(f"  m={m} registered kinds: {registered_kinds(m)}")
    for nb in (16, 128, 1024):
        s_h = SimplexSchedule(2, nb, "hmap").steps
        s_bb = SimplexSchedule(2, nb, "bb").steps
        print(f"  m=2 n={nb:5d}:  H {s_h:>9,} steps   BB {s_bb:>9,} steps   "
              f"ratio {s_bb / s_h:.3f}x  (the paper's MAP speedup)")
        check(s_h == tri(nb), f"m=2 n={nb}: H launches tri(n) steps")
    print("  beyond the paper: the m>=4 recursive map (DESIGN.md §4)")
    for m in (3, 4, 5):
        sched, bb = SimplexSchedule(m, 64, "hmap"), SimplexSchedule(m, 64, "bb")
        print(f"  m={m} n=64: H {sched.steps:>10,} steps (waste {sched.waste():+.2f})   "
              f"BB {bb.steps:>12,}   ratio {bb.steps / sched.steps:.1f}x "
              f"(bound m! = {math.factorial(m)}x)")
        check(bb.steps / sched.steps <= math.factorial(m),
              f"m={m}: the bounding box over H within m!")


def composite(device: torch.device) -> None:
    """3. Any n through the composite decomposition, on the kernels too."""
    _section("3. Any n, analytically: the composite decomposition (§4.2)")
    kind = resolve_kind(3, 100, "hmap")
    print(f"  resolve_kind(3, 100, 'hmap') -> {kind!r}")
    sched, table = SimplexSchedule(3, 100, kind), SimplexSchedule(3, 100, "table")
    print(f"  m=3 n=100: composite {sched.steps:,} steps (waste {sched.waste():+.1%}, "
          f"O(pieces) build)   table {table.steps:,} steps (O(V) build)")
    sched4 = SimplexSchedule(4, 24, resolve_kind(4, 24, "hmap"))
    print(f"  m=4 n=24:  composite {sched4.steps:,} steps (waste {sched4.waste():+.1%})")
    tab = sched.table()
    pts = tab[tab[:, -1] == 1, :3]
    check(kind == "composite" and len(np.unique(pts, axis=0)) == len(pts) == sched.useful,
          f"{len(pts):,} cells of T(100) covered exactly once by the composite walk")
    g = torch.Generator().manual_seed(3)
    x3 = torch.randint(0, 9, (12, 12, 12), generator=g, dtype=torch.int32)
    got3 = ops.simplex_accum3d(x3, rho=2, kind="hmap", device=device).cpu()
    mask = R.simplex_mask(3, 12)
    check(torch.equal(got3[mask], x3[mask] + 1) and torch.equal(got3[~mask], x3[~mask]),
          "ACCUM3D at nb=6 (the composite walk) equals the oracle")


def kernels(device: torch.device) -> None:
    """4. ACCUM, EDM and m=4 ACCUM against their oracles."""
    _section(f"4. Kernels on the simplex ({device.type}), against the oracles")
    g = torch.Generator().manual_seed(0)
    xx = torch.randint(0, 9, (64, 64), generator=g, dtype=torch.int32)
    got = ops.simplex_accum2d(xx, rho=8, kind="hmap", device=device).cpu()
    tri_mask = R.tril_mask(64)
    check(torch.equal(got[tri_mask], R.accum2d(xx)[tri_mask]),
          "ACCUM (H grid) equals the oracle on the triangle")
    p = torch.randn((64, 8), generator=g)
    got = ops.simplex_edm2d(p, rho=8, kind="hmap", device=device).cpu()
    want = R.edm2d(p)
    err = float(((got - want) * R.tril_mask(64, torch.float32)).abs().max())
    check(err <= EDM_TOL[0] + EDM_TOL[1] * float(want.abs().max()),
          f"EDM (H grid) max err {err:.3e}")
    x4 = torch.randint(0, 9, (8, 8, 8, 8), generator=g, dtype=torch.int32)
    got4 = ops.simplex_accum_md(x4, rho=2, kind="hmap", device=device).cpu()
    m4 = R.simplex_mask(4, 8)
    check(torch.equal(got4[m4], x4[m4] + 1),
          "ACCUM4D (m=4 recursive H grid) equals the oracle on the simplex")


def flash(device: torch.device) -> None:
    """5. The folded flash forward against dense causal attention."""
    _section("5. Causal attention IS a 2-simplex: folded flash kernel")
    g = torch.Generator().manual_seed(1)
    q = torch.randn((1, 4, 256, 32), generator=g)
    k, v = (torch.randn((1, 2, 256, 32), generator=g) for _ in range(2))
    out = ops.causal_flash_attention(q, k, v, kind="folded", block_q=64, block_kv=64,
                                     device=device).cpu()
    want = R.causal_attention(q, k, v)
    err = float((out - want).abs().max())
    check(err <= FLASH_TOL[0] + FLASH_TOL[1] * float(want.abs().max()),
          f"folded flash vs dense attention max err {err:.3e}")
    print(f"  grid steps: folded {flash_grid_steps(4, 'folded')} "
          f"vs bb {flash_grid_steps(4, 'bb')}")


def main(argv=None) -> None:
    """Every section; raises ``ExampleCheckFailed`` on a failed check."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    device = resolve_device(ap.parse_args(argv).device)
    coverage()
    schedules()
    composite(device)
    kernels(device)
    flash(device)


if __name__ == "__main__":
    main()
