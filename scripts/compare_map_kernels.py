#!/usr/bin/env python3
"""Time every kernel on the device map from two source trees in turns on
one card: MAP, ACCUM, CA, EDM, the m >= 3 originals and the 2-D ACCUM,
EDM and CA originals; and the tensor-core map.

Two calls to the card may land on two cards with other power limits, so
a change to ``kernels/csrc/simplex_maps.cuh`` or to one of its users is
compared with its base inside one process: the users' sources
(``map.cu``, ``accum.cu``, ``ca.cu``, ``edm.cu``, ``legacy_md.cu``,
``legacy2d.cu``) and ``hmap_mxu.cu`` of each tree are compiled into a
library of their own,
and each case runs base, change, change, base, its time the median of
``RUNS`` CUDA-event timed runs after warm-up.  The Python side is this
tree's, so the base must export the same C entry points
(``kernels/_build.py``), except that a base whose ``legacy_accum3d_launch``
and ``legacy_accum_md_launch``, ``legacy_ca3d_launch``,
``legacy_edm2d_launch``, ``legacy_accum2d_launch`` or
``legacy_ca2d_launch`` take no ``vec`` argument (before those originals
took 16-byte pieces) is called with its own argument list.  Every
case's outputs must agree between the trees (integers bit for bit, EDM
within ``1e-5 + 1e-5 * max|p|``); the script exits 1 where they do not.

The cases are the head cases of ``chip_smoke.py`` (int32, EDM in
float32 with d = 64): MAP at m=2 hmap nb=16384, m=3 octant nb=512 and
m=4 hmap nb=16; ACCUM, CA and EDM at m=2 hmap n=16384 rho=16 and m=3
octant n=1024 rho=8, ACCUM and EDM also at m=4 hmap n=64 rho=4;
``accum3d`` and ``accum_md`` at m=3 n=1024 rho=8 for hmap, octant, table
and bb and at n=960 for composite (fused and one launch per piece) and
bb, ``accum_md`` also at m=4 hmap n=64 rho=4; ``ca3d`` at m=3 n=1024
rho=8 for hmap, octant, table and bb and at n=960 for composite and bb;
``edm2d`` at m=2 n=16384 rho=16, d=64, float32, for hmap, rb and bb;
``accum2d`` and ``ca2d`` (0/1 states of density 0.35) at m=2 n=16384
rho=16, int32, for hmap, rb and bb; the tensor-core map over the hmap2
grid of nb=16384 at rho=16 (134,209,536 blocks).  Each
prints ``compare <case> base=<ms>/<ms> change=<ms>/<ms>`` (both runs of
each) and the change's time over the base's.

Run from the repository root on a card, with the base unpacked into a
git-ignored directory::

    mkdir -p build/base && git archive <ref> src/repro_torch/kernels/csrc | tar -x -C build/base
    python3 scripts/compare_map_kernels.py --base build/base
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
USERS = ("map.cu", "accum.cu", "ca.cu", "edm.cu", "legacy_md.cu", "legacy2d.cu", "hmap_mxu.cu")
RUNS = 10
# (m, n, rho, kind, split) of the ACCUM originals, int32.
LEGACY_ACCUM_CASES = (
    (3, 1024, 8, "hmap", None), (3, 1024, 8, "octant", None), (3, 1024, 8, "table", None),
    (3, 1024, 8, "bb", None), (3, 960, 8, "composite", False), (3, 960, 8, "composite", True),
    (3, 960, 8, "bb", None), (4, 64, 4, "hmap", None))
# (n, rho, kind) of the CA original, int32 0/1 states of density 0.35.
LEGACY_CA3D_CASES = ((1024, 8, "hmap"), (1024, 8, "octant"), (1024, 8, "table"),
                     (1024, 8, "bb"), (960, 8, "composite"), (960, 8, "bb"))
# (n, rho, d, kind) of the 2-D EDM original, float32 points.
LEGACY_EDM2D_CASES = tuple((16384, 16, 64, kind) for kind in ("hmap", "rb", "bb"))
# (n, rho, kind) of the 2-D ACCUM and CA originals, int32.
LEGACY_2D_CASES = tuple((16384, 16, kind) for kind in ("hmap", "rb", "bb"))
_P, _I = ctypes.c_void_p, ctypes.c_int


def takes_vec(csrc: pathlib.Path, source: str, entry: str) -> bool:
    """Whether ``entry`` of ``csrc/source`` takes a ``vec`` argument."""
    found = re.search(rf'extern "C" int {entry}\(([^)]*)\)', (csrc / source).read_text())
    return found is not None and "vec" in found.group(1)


def build(csrc: pathlib.Path, out: pathlib.Path, nvcc: str, flags) -> ctypes.CDLL:
    """Compile the map's users of ``csrc`` (in parallel) into one library."""
    out.mkdir(parents=True)
    procs = [subprocess.Popen([nvcc, *flags, "-c", str(csrc / cu), "-o", str(out / f"{cu}.o")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cu in USERS]
    for cu, proc in zip(USERS, procs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {csrc / cu}:\n{log}")
    lib = out / "lib.so"
    subprocess.run([nvcc, *flags, "-shared", *(str(out / f"{cu}.o") for cu in USERS),
                    "-o", str(lib)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def main(argv=None) -> int:
    """Build both trees, run every case in turns, print one line a case."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=pathlib.Path,
                    help="a tree holding src/repro_torch/kernels/csrc")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("compare_map_kernels.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, engine, legacy
    from repro_torch.kernels import hmap_mxu as TM

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
    nvcc = _build.nvcc_path()
    libs = {}
    for tag, csrc in (("base", args.base / "src/repro_torch/kernels/csrc"),
                      ("change", _build.CSRC)):
        lib = build(csrc, tmp / tag, nvcc, _build.NVCC_FLAGS)
        for name, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = list(argtypes)
                getattr(lib, name).restype = ctypes.c_int
        libs[tag] = lib
    base_csrc = args.base / "src/repro_torch/kernels/csrc"
    base_takes_vec = takes_vec(base_csrc, "legacy_md.cu", "legacy_accum3d_launch")
    if not base_takes_vec:
        for name in ("legacy_accum3d_launch", "legacy_accum_md_launch"):
            getattr(libs["base"], name).argtypes = [_P, _I, _P, _P, _I, _I, _P]
    base_ca_vec = takes_vec(base_csrc, "legacy_md.cu", "legacy_ca3d_launch")
    if not base_ca_vec:
        libs["base"].legacy_ca3d_launch.argtypes = [_P, _P, _I, _P, _P, _I, _I, _P]
    base_edm_vec = takes_vec(base_csrc, "legacy2d.cu", "legacy_edm2d_launch")
    if not base_edm_vec:
        libs["base"].legacy_edm2d_launch.argtypes = [_P, _I, _P, _I, _I, _I, _I, _I, _P]
    base_accum2d_vec = takes_vec(base_csrc, "legacy2d.cu", "legacy_accum2d_launch")
    if not base_accum2d_vec:
        libs["base"].legacy_accum2d_launch.argtypes = [_P, _I, _I, _I, _I, _I, _P]
    base_ca2d_vec = takes_vec(base_csrc, "legacy2d.cu", "legacy_ca2d_launch")
    if not base_ca2d_vec:
        libs["base"].legacy_ca2d_launch.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P]

    def legacy_accum(k, buf, sched, rho) -> None:
        """``k.kernel_``, or the base's entry with its own arguments."""
        if _build._LIB is libs["base"] and not base_takes_vec:
            code = getattr(_build._LIB, k.entry)(
                buf.data_ptr(), legacy.DTYPE_CODES[buf.dtype], *legacy._desc_args(sched, dev),
                buf.shape[0], rho, torch.cuda.current_stream().cuda_stream)
            _build.check(code, k.name)
        else:
            k.kernel_(buf, sched, rho)

    def legacy_ca3d(out, st, sched, rho) -> None:
        """``CA3D.kernel_``, or the base's entry with its own arguments."""
        if _build._LIB is libs["base"] and not base_ca_vec:
            code = _build._LIB.legacy_ca3d_launch(
                out.data_ptr(), st.data_ptr(), legacy.DTYPE_CODES[st.dtype],
                *legacy._desc_args(sched, dev), st.shape[0], rho,
                torch.cuda.current_stream().cuda_stream)
            _build.check(code, "ca3d")
        else:
            legacy.CA3D.kernel_(out, st, sched, rho)

    def legacy_edm2d(out, p, sched, rho) -> None:
        """``EDM2D.kernel_``, or the base's entry with its own arguments."""
        if _build._LIB is libs["base"] and not base_edm_vec:
            code = _build._LIB.legacy_edm2d_launch(
                out.data_ptr(), legacy.DTYPE_CODES[out.dtype], p.data_ptr(), p.shape[1],
                legacy._KIND_CODES[sched.kind], sched.n, out.shape[0], rho,
                torch.cuda.current_stream().cuda_stream)
            _build.check(code, "edm2d")
        else:
            legacy.EDM2D.kernel_(out, p, sched, rho)

    def legacy_accum2d(buf, sched, rho) -> None:
        """``ACCUM2D.kernel_``, or the base's entry with its own arguments."""
        if _build._LIB is libs["base"] and not base_accum2d_vec:
            code = _build._LIB.legacy_accum2d_launch(
                buf.data_ptr(), legacy.DTYPE_CODES[buf.dtype], legacy._KIND_CODES[sched.kind],
                sched.n, buf.shape[0], rho, torch.cuda.current_stream().cuda_stream)
            _build.check(code, "accum2d")
        else:
            legacy.ACCUM2D.kernel_(buf, sched, rho)

    def legacy_ca2d(out, st, sched, rho) -> None:
        """``CA2D.kernel_``, or the base's entry with its own arguments."""
        if _build._LIB is libs["base"] and not base_ca2d_vec:
            code = _build._LIB.legacy_ca2d_launch(
                out.data_ptr(), st.data_ptr(), legacy.DTYPE_CODES[st.dtype],
                legacy._KIND_CODES[sched.kind], sched.n, st.shape[0], rho,
                torch.cuda.current_stream().cuda_stream)
            _build.check(code, "ca2d")
        else:
            legacy.CA2D.kernel_(out, st, sched, rho)

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

    def compare(label, fn, result, reset=None) -> None:
        """Run ``fn`` from each tree in turns; ``result()`` reads its
        output after one call from the state ``reset()`` restores."""
        times = {"base": [], "change": []}
        outs = {}
        for tag in ("base", "change", "change", "base"):
            _build._LIB = libs[tag]
            if reset:
                reset()
            fn()
            torch.cuda.synchronize()
            outs.setdefault(tag, result())
            times[tag].append(time_ms(fn))
        a, b = outs["base"], outs["change"]
        if a.dtype.is_floating_point:
            same = (a - b).abs().max().item() <= 1e-5 + 1e-5 * a.abs().max().item()
        else:
            same = torch.equal(a, b)
        if not same:
            failures.append(label)
        base, change = statistics.mean(times["base"]), statistics.mean(times["change"])
        print(f"compare {label} base={times['base'][0]:.4f}/{times['base'][1]:.4f} "
              f"change={times['change'][0]:.4f}/{times['change'][1]:.4f} "
              f"change/base={change / base:.3f} agree={same}", flush=True)

    mapb = engine.get_body("map")
    for m, nb, kind in ((2, 16384, "hmap"), (3, 512, "octant"), (4, 16, "hmap")):
        sched = engine.schedule_for(m, nb, kind)
        box = {}
        compare(f"map m={m} nb={nb} kind={kind}",
                lambda: box.__setitem__("out", mapb.kernel(sched, 128, dev)),
                lambda: box.pop("out"))
    for m, n, rho, kind in ((2, 16384, 16, "hmap"), (3, 1024, 8, "octant"), (4, 64, 4, "hmap")):
        sched = engine.schedule_for(m, n // rho, kind)
        x = torch.randint(0, 100, (n,) * m, generator=gen, device=dev, dtype=torch.int32)
        buf = x.clone()
        compare(f"accum m={m} n={n} kind={kind}",
                lambda: engine.get_body("accum").kernel_(buf, sched, rho),
                lambda: buf.clone(), lambda: buf.copy_(x))
        del x, buf
        if m <= 3:
            st = (torch.rand((n,) * m, generator=gen, device=dev) < 0.4).to(torch.int32)
            out = st.clone()
            compare(f"ca m={m} n={n} kind={kind}",
                    lambda: engine.get_body("ca").kernel_(out, st, sched, rho),
                    lambda: out.clone())
            del st, out
        p = torch.randn((n, 64), generator=gen, device=dev)
        out = torch.zeros((n,) * m, device=dev)
        compare(f"edm m={m} n={n} kind={kind}",
                lambda: engine.get_body("edm").kernel_(out, p, sched, rho),
                lambda: out.clone())
        del p, out
        torch.cuda.empty_cache()
    for m, n, rho, kind, split in LEGACY_ACCUM_CASES:
        plan = legacy._launch_plan(m, n // rho, kind, split)
        x = torch.randint(0, 100, (n,) * m, generator=gen, device=dev, dtype=torch.int32)
        buf = x.clone()
        names = (("accum3d", legacy.ACCUM3D), ("accum_md", legacy.ACCUM_MD)) if m == 3 else (
            ("accum_md", legacy.ACCUM_MD),)
        for name, k in names:
            compare(f"{name} m={m} n={n} kind={kind} split={split}",
                    lambda: [legacy_accum(k, buf, s, rho) for s in plan],
                    lambda: buf.clone(), lambda: buf.copy_(x))
        del x, buf
        torch.cuda.empty_cache()
    for n, rho, kind in LEGACY_CA3D_CASES:
        sched = legacy._schedule(3, n // rho, kind)
        st = (torch.rand((n,) * 3, generator=gen, device=dev) < 0.35).to(torch.int32)
        out = st.clone()
        compare(f"ca3d m=3 n={n} kind={kind}", lambda: legacy_ca3d(out, st, sched, rho),
                lambda: out.clone())
        del st, out
        torch.cuda.empty_cache()
    for n, rho, d, kind in LEGACY_EDM2D_CASES:
        sched = legacy._schedule(2, n // rho, kind)
        p = torch.randn((n, d), generator=gen, device=dev)
        out = torch.zeros((n, n), device=dev)
        compare(f"edm2d m=2 n={n} d={d} kind={kind}", lambda: legacy_edm2d(out, p, sched, rho),
                lambda: out.clone())
        del p, out
        torch.cuda.empty_cache()
    for n, rho, kind in LEGACY_2D_CASES:
        sched = legacy._schedule(2, n // rho, kind)
        x = torch.randint(0, 100, (n, n), generator=gen, device=dev, dtype=torch.int32)
        buf = x.clone()
        compare(f"accum2d m=2 n={n} kind={kind}", lambda: legacy_accum2d(buf, sched, rho),
                lambda: buf.clone(), lambda: buf.copy_(x))
        del x, buf
        st = (torch.rand((n, n), generator=gen, device=dev) < 0.35).to(torch.int32)
        out = st.clone()
        compare(f"ca2d m=2 n={n} kind={kind}", lambda: legacy_ca2d(out, st, sched, rho),
                lambda: out.clone())
        del st, out
        torch.cuda.empty_cache()
    nb, rho = 16384, 16
    wy, wx = torch.meshgrid(torch.arange(1, nb, device=dev), torch.arange(nb // 2, device=dev),
                            indexing="ij")
    wxy = torch.stack([wx.reshape(-1), wy.reshape(-1)], 1).to(torch.int32)
    del wx, wy
    box = {}
    compare(f"hmap_mxu nb={nb} rho={rho}",
            lambda: box.__setitem__("out", TM.HMAP_MXU.kernel(wxy, rho)), lambda: box.pop("out"))
    del wxy, box
    torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    if failures:
        print(f"outputs differ between the trees: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
