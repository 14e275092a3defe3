#!/usr/bin/env python3
"""Time variants of the redesigned originals ``ca3d``, ``edm2d``,
``accum2d`` and ``ca2d`` in turns on one card: what each part of their
designs buys, and what bounds them.

Each variant is this tree's ``legacy_md.cu`` or ``legacy2d.cu`` with a
few lines replaced, compiled into a library of its own; the Python side
(``kernels/legacy.py``) is this tree's.  Every case runs the variants in
turns (forward, then backward, three rounds), each time the median of
``RUNS`` CUDA-event timed runs after warm-up, and prints one line per
variant with its ptxas registers and spills.  A variant marked
``diagnostic`` drops work (its output is wrong and not compared); the
others must agree with the tree's own kernel (CA bit for bit, EDM within
``1e-5 + 1e-5 * max|p|``), else the script exits 1.  A replacement that
no longer matches the source stops the script: the variants follow the
sources of this tree.

Variants of ``ca3d`` (m=3 n=1024 rho=8 int32, hmap, table and bb):
``warp_halo`` (every warp stages its own halo: the shared halo's gain),
``no_count`` and ``no_stage`` (diagnostic: staging alone, the count
alone).  Of ``edm2d`` (n=16384 rho=16 d=64 float32, hmap, rb and bb):
``rows8`` (8 x 4 cells a thread), ``blocks4`` (a cap of four blocks an SM
instead of five: more registers) and ``cells`` (each cell stored alone).
Of ``accum2d`` (n=16384 rho=16 int32, hmap, rb and bb): ``warp_tile``
(every warp walks its own tile: what walking the block's rows together
buys), ``blocks6`` (a cap of six blocks an SM instead of four: fewer
registers), ``unroll4`` (four pieces a lane in flight) and ``l2plain``
(loads without the 128-byte L2 fetch).  Of ``ca2d`` (n=16384 rho=16
int32 0/1, hmap, rb and bb): ``warp_halo`` (every warp stages its own
halo: the shared halo's gain), ``blocks5`` (a cap of five blocks an SM
instead of four: fewer registers), ``no_count`` and ``no_stage``
(diagnostic: staging alone, the count alone).

Run from the repository root on a card, with the kernels to time (all
four where none is named)::

    python3 scripts/legacy_variants.py
    python3 scripts/legacy_variants.py accum2d ca2d
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNS, ROUNDS = 10, 3
MD, L2D = "legacy_md.cu", "legacy2d.cu"
# name: (source, [(old, new), ...], diagnostic)
VARIANTS = {
    "ca3d": {
        "warp_halo": (MD, [("  bool shared = true, any = false;",
                            "  bool shared = false, any = false;")], False),
        "no_count": (MD, [("    if (mine)\n      legacy_ca3d_count",
                           "    if (false)\n      legacy_ca3d_count")], True),
        "no_stage": (MD, [("    if (shared || mine)\n      legacy_ca3d_stage",
                           "    if (false)\n      legacy_ca3d_stage")], True),
    },
    "edm2d": {
        "rows8": (L2D, [("#define LEGACY_EDM_ROWS 4 ", "#define LEGACY_EDM_ROWS 8 ")], False),
        "blocks4": (L2D, [("#define LEGACY_EDM_BLOCKS 5 ", "#define LEGACY_EDM_BLOCKS 4 ")],
                    False),
        "cells": (L2D, [("          if ((rho & 3) == 0 && col0 + 3 < rho && C0 + 3 <= R) {",
                         "          if (false) {")], False),
    },
    "accum2d": {
        "warp_tile": (L2D, [("    const bool together = b.mode != LEGACY2D_ALONE;",
                             "    const bool together = false;")], False),
        "blocks6": (L2D, [("#define LEGACY2D_ACCUM_BLOCKS 4 ", "#define LEGACY2D_ACCUM_BLOCKS 6 ")],
                    False),
        "unroll4": (L2D, [("#define LEGACY2D_UNROLL 2 ", "#define LEGACY2D_UNROLL 4 ")], False),
        "l2plain": (L2D, [("            v[u] = legacy2d_load_piece(p[u]);",
                           "            v[u] = *reinterpret_cast<const uint4*>(p[u]);")], False),
    },
    "ca2d": {
        "warp_halo": (L2D, [("  const bool shared = b.mode != LEGACY2D_ALONE;",
                             "  const bool shared = false;")], False),
        "blocks5": (L2D, [("#define LEGACY2D_CA_BLOCKS 4 ", "#define LEGACY2D_CA_BLOCKS 5 ")],
                    False),
        "no_count": (L2D, [("    if (warp < b.cnt)\n      legacy_ca2d_count",
                            "    if (false)\n      legacy_ca2d_count")], True),
        "no_stage": (L2D, [("    legacy_ca2d_stage<T, PE>(halo, in, b.y0 * rho - 1,",
                            "    if (false) legacy_ca2d_stage<T, PE>(halo, in, b.y0 * rho - 1,")],
                     True),
    },
}


def build(csrc: pathlib.Path, source: str, reps, out: pathlib.Path, nvcc: str, flags):
    """``(process, object)``: one variant's object compiling in the background."""
    out.mkdir(parents=True)
    for f in csrc.glob("*.cuh"):
        shutil.copy(f, out / f.name)
    text = (csrc / source).read_text()
    for old, new in reps:
        if old not in text:
            raise SystemExit(f"legacy_variants.py: {out.name}: {old!r} is not in {source}")
        text = text.replace(old, new)
    (out / source).write_text(text)
    obj = out / "k.o"
    proc = subprocess.Popen(
        [nvcc, *flags, "-Xptxas", "-v", "-c", str(out / source), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, obj


def ptxas(log: str, kernel: str) -> str:
    """Registers, stack and spills of the kernels named ``kernel``."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
        elif cur and kernel in cur and ("registers" in line or "stack frame" in line):
            out.append(line.split(":", 1)[-1].strip())
    return "; ".join(out)


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [k for k in names if k not in VARIANTS]
    if unknown:
        print(f"legacy_variants.py: no variants of {unknown}; kernels: {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("legacy_variants.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, legacy

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
    nvcc = _build.nvcc_path()
    jobs = {}
    for kernel in names:
        variants = VARIANTS[kernel]
        source = MD if kernel == "ca3d" else L2D
        jobs[(kernel, "tree")] = build(_build.CSRC, source, [], tmp / f"{kernel}_tree", nvcc,
                                       _build.NVCC_FLAGS) + (False,)
        for name, (src, reps, diag) in variants.items():
            jobs[(kernel, name)] = build(_build.CSRC, src, reps, tmp / f"{kernel}_{name}", nvcc,
                                         _build.NVCC_FLAGS) + (diag,)
    libs, info = {}, {}
    for key, (proc, obj, diag) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {key}:\n{log}")
        lib = obj.with_suffix(".so")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", str(obj), "-o", str(lib)],
                       check=True)
        libs[key] = ctypes.CDLL(str(lib))
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(libs[key], fn):
                getattr(libs[key], fn).argtypes = list(argtypes)
                getattr(libs[key], fn).restype = ctypes.c_int
        info[key] = (diag, ptxas(log, f"legacy_{key[0]}_kernel"))

    def time_ms(fn) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(RUNS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    failures = []

    def cases(kernel, label, make, call) -> None:
        keys = [k for k in libs if k[0] == kernel]
        times = {k: [] for k in keys}
        ref, agree = None, {}
        for r in range(ROUNDS):
            for key in keys if r % 2 == 0 else keys[::-1]:
                _build._LIB = libs[key]
                out = make()
                call(out)
                torch.cuda.synchronize()
                if r == 0 and not info[key][0]:
                    if ref is None:
                        ref = out.clone()
                    if out.dtype.is_floating_point:
                        tol = 1e-5 + 1e-5 * ref.abs().max().item()
                        agree[key] = (out - ref).abs().max().item() <= tol
                    else:
                        agree[key] = torch.equal(out, ref)
                    if not agree[key]:
                        failures.append(f"{label} {key[1]}")
                times[key].append(time_ms(lambda: call(out)))
                del out
        base = statistics.median(times[(kernel, "tree")])
        for key in keys:
            ms = statistics.median(times[key])
            print(f"variant {label} {key[1]} ms={ms:.4f} over_tree={ms / base:.3f} "
                  f"runs={['%.4f' % t for t in times[key]]} "
                  f"{'diagnostic' if info[key][0] else 'agree=' + str(agree.get(key))} "
                  f"ptxas: {info[key][1]}", flush=True)

    if "ca3d" in names:
        n, rho = 1024, 8
        st = (torch.rand((n,) * 3, generator=gen, device=dev) < 0.35).to(torch.int32)
        for kind in ("hmap", "table", "bb"):
            sched = legacy._schedule(3, n // rho, kind)
            cases("ca3d", f"ca3d m=3 n={n} rho={rho} kind={kind}", lambda: st.clone(),
                  lambda out: legacy.CA3D.kernel_(out, st, sched, rho))
        del st
        torch.cuda.empty_cache()
    n, rho, d = 16384, 16, 64
    if "edm2d" in names:
        p = torch.randn((n, d), generator=gen, device=dev)
        for kind in ("hmap", "rb", "bb"):
            sched = legacy._schedule(2, n // rho, kind)
            cases("edm2d", f"edm2d m=2 n={n} rho={rho} d={d} kind={kind}",
                  lambda: torch.zeros((n, n), device=dev),
                  lambda out: legacy.EDM2D.kernel_(out, p, sched, rho))
        del p
        torch.cuda.empty_cache()
    if "accum2d" in names:
        x = torch.randint(0, 100, (n, n), generator=gen, device=dev, dtype=torch.int32)
        for kind in ("hmap", "rb", "bb"):
            sched = legacy._schedule(2, n // rho, kind)
            cases("accum2d", f"accum2d m=2 n={n} rho={rho} kind={kind}", lambda: x.clone(),
                  lambda out: legacy.ACCUM2D.kernel_(out, sched, rho))
        del x
        torch.cuda.empty_cache()
    if "ca2d" in names:
        st = (torch.rand((n, n), generator=gen, device=dev) < 0.35).to(torch.int32)
        for kind in ("hmap", "rb", "bb"):
            sched = legacy._schedule(2, n // rho, kind)
            cases("ca2d", f"ca2d m=2 n={n} rho={rho} kind={kind}", lambda: st.clone(),
                  lambda out: legacy.CA2D.kernel_(out, st, sched, rho))
        del st
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        print(f"variants disagree with the tree: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
