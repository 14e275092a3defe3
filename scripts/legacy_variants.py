#!/usr/bin/env python3
"""Time variants of the redesigned originals ``ca3d``, ``edm2d``,
``accum2d`` and ``ca2d`` and of the tensor-core map ``hmap_mxu`` in turns
on one card: what each part of their designs buys, and what bounds them.

Each variant is this tree's ``legacy_md.cu``, ``legacy2d.cu`` or
``hmap_mxu.cu`` with a few lines replaced, compiled into a library of its
own; the Python side (``kernels/legacy.py``, ``kernels/hmap_mxu.py``) is
this tree's.  Every case runs the variants in
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
(diagnostic: staging alone, the count alone).  Of ``hmap_mxu`` (the
hmap2 grid of nb=16384, rho=16, 134,209,536 blocks, on an aligned input
and on a view 8 bytes off a 16-byte boundary, the tree's output held
against the plain version; one ``copy_`` of the same bytes beside them):
``ahead1`` and ``ahead4`` (the 16 MMAs unrolled by 1 or 4 instead of
all: fewer loads in flight), ``persistent`` (a grid of as many blocks as
fit, each warp looping over groups), ``fadd`` (conversions by float64
additions instead of the conversion instructions), ``first_port`` (the
first port's kernel: blocks as B's columns, scalar stores),
``wide_loads`` (the same with 16-byte loads and fragments formed by
shuffles), ``ring2``, ``ring4``, ``ring8`` (the tree's product over a
ring of 2, 4 or 8 tiles of 128 blocks a warp in shared memory, 16-byte
cp.async copies in, 16-byte stores out, a persistent grid) and
``cuda_cores`` (measurement only: the same map with integer
multiply-adds on the CUDA cores instead of the FP64 MMA, its 16 loads
issued first behind a compiler barrier so that they stay in flight, the
tree's stores; never on any path).  The 16-byte variants are left out on
the view 8 bytes off.

Run from the repository root on a card, with the kernels to time (all
five where none is named)::

    python3 scripts/legacy_variants.py
    python3 scripts/legacy_variants.py accum2d ca2d
    python3 scripts/legacy_variants.py hmap_mxu
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
MD, L2D, MXU = "legacy_md.cu", "legacy2d.cu", "hmap_mxu.cu"
# hmap_mxu.cu's hooks: the line that launches the kernel, the kernel's
# first line, before which a variant puts its own functions, the head of
# the loop over a group's 16 MMAs, and the product and store of one MMA.
MXU_LAUNCH = ("  hmap2_coords_mxu_kernel<<<(unsigned)blocks, HMAP_MXU_WARPS * 32, 0, st>>>(o, w, "
              "groups, rho);")
MXU_KERNEL = "__global__ void __launch_bounds__(HMAP_MXU_WARPS * 32)\n    hmap2_coords_mxu_kernel("
MXU_LOOP = """#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int2 w = wxy[base + 8 * j];"""
MXU_PRODUCT = """    hmap_mxu_dmma((double)v, b, &d0, &d1);
    if (k == 0)  // D[r][0] and D[r][1]: block r's (x, y)
      out[base + 8 * j] = make_int2((int)__double2ll_rn(d0), (int)__double2ll_rn(d1));"""
# All 16 loads before the first product, the empty asm's memory clobber
# keeping them there: without it the compiler sinks each of cuda_cores's
# loads to its use, one load a lane in flight.
MXU_FIRST = """  int2 ws[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) ws[j] = wxy[base + 8 * j];
  asm volatile("" ::: "memory");
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int2 w = ws[j];"""
MXU_GROUP = ("  const long long group = (long long)blockIdx.x * HMAP_MXU_WARPS + "
             "(threadIdx.x >> 5);\n  if (group >= groups) return;  // uniform in the warp\n")
# The first port's product (blocks as B's columns, x and y in D's rows 0 and
# 1, lanes 0-7 storing them as scalars), a warp per 128 blocks, 8 a block;
# WIDE_LOADS reads 16-byte pieces and forms the fragments by shuffles.
MXU_COLUMNS = """
template <bool WIDE_LOADS>
__global__ void hmap_mxu_v_columns(int* __restrict__ out, const int2* __restrict__ wxy,
                                   long long groups, int rho) {
  const long long group = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (group >= groups) return;
  const int lane = threadIdx.x & 31, row = lane >> 2, k = lane & 3;
  double a = 0.0;
  if (row == 0 && (k == 0 || k == 2)) a = rho;
  if (row == 1 && k == 1) a = rho;
  if (row == 1 && k == 2) a = 2.0 * rho;
  const long long base = group * 128;
  int4 v0 = make_int4(0, 0, 0, 0), v1 = v0;
  if (WIDE_LOADS) {
    v0 = reinterpret_cast<const int4*>(wxy + base)[lane];
    v1 = reinterpret_cast<const int4*>(wxy + base + 64)[lane];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    int2 w;
    if (WIDE_LOADS) {
      const int4 v = i < 8 ? v0 : v1;
      const int src = 4 * (i & 7) + (row >> 1);
      const int x0 = __shfl_sync(0xffffffffu, v.x, src), y0 = __shfl_sync(0xffffffffu, v.y, src);
      const int x1 = __shfl_sync(0xffffffffu, v.z, src), y1 = __shfl_sync(0xffffffffu, v.w, src);
      w = (row & 1) ? make_int2(x1, y1) : make_int2(x0, y0);
    } else {
      w = wxy[base + i * 8 + row];
    }
    const int b = 1 << (31 - __clz(w.y > 1 ? w.y : 1));
    const int qb = w.x & ~(b - 1);
    const double bv = k == 0 ? (double)w.x : k == 1 ? (double)w.y : k == 2 ? (double)qb : 0.0;
    double d0, d1;
    hmap_mxu_dmma(a, bv, &d0, &d1);
    if (row < 2) {
      int* o = out + (base + i * 8 + 2 * k) * 2 + row;
      o[0] = (int)__double2ll_rn(d0);
      o[2] = (int)__double2ll_rn(d1);
    }
  }
}
"""
# The tree's product over a ring instead: each warp copies tiles of 128
# blocks into a ring of STAGES in shared memory (16-byte cp.async pieces,
# STAGES - 1 tiles in flight), reads the fragments there, writes (x, y)
# back over the input and stores the tile in 16-byte pieces; a persistent
# grid.  A 16-byte-aligned input only.
MXU_RING = """
template <int STAGES>
__global__ void __launch_bounds__(256)
    hmap_mxu_v_ring(int2* __restrict__ out, const int2* __restrict__ wxy, long long t, int rho) {
  extern __shared__ int4 ring_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r = lane >> 2, k = lane & 3;
  int2* ring = reinterpret_cast<int2*>(ring_smem) + warp * STAGES * 128;
  const long long tiles = t / 128, stride = (long long)gridDim.x * 8;
  const long long first = (long long)blockIdx.x * 8 + warp;
  double b = 0.0;
  if (r == 0 && (k == 0 || k == 2)) b = rho;
  if (r == 1 && k == 1) b = rho;
  if (r == 1 && k == 2) b = 2.0 * rho;
  auto load = [&](int2* s, long long tile) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = (i * 32 + lane) * 2;
      const unsigned d = (unsigned)__cvta_generic_to_shared(s + blk);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(d),
                   "l"(wxy + tile * 128 + blk) : "memory");
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (first + i * stride < tiles) load(ring + i * 128, first + i * stride);
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
  }
  int stage = 0;
  for (long long tile = first; tile < tiles; tile += stride) {
    const int slot = stage == 0 ? STAGES - 1 : stage - 1;
    if (tile + (STAGES - 1) * stride < tiles)
      load(ring + slot * 128, tile + (STAGES - 1) * stride);
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\\n" ::"n"(STAGES - 1) : "memory");
    __syncwarp();
    int2* s = ring + stage * 128;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int2* p = s + 8 * j + r;
      const int2 w = *p;
      const int bw = 1 << (31 - __clz(w.y > 1 ? w.y : 1));
      const int qb = w.x & ~(bw - 1);
      const int v = k == 0 ? w.x : k == 1 ? w.y : k == 2 ? qb : 0;
      double d0, d1;
      hmap_mxu_dmma((double)v, b, &d0, &d1);
      if (k == 0) *p = make_int2((int)__double2ll_rn(d0), (int)__double2ll_rn(d1));
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = (i * 32 + lane) * 2;
      *reinterpret_cast<int4*>(out + tile * 128 + blk) = *reinterpret_cast<const int4*>(s + blk);
    }
    __syncwarp();
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  }
}

template <int STAGES>
static void hmap_mxu_v_ring_launch(int2* o, const int2* w, long long t, int rho, cudaStream_t st) {
  const int smem = 8 * STAGES * 128 * 8;
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncSetAttribute(hmap_mxu_v_ring<STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hmap_mxu_v_ring<STAGES>, 256, smem);
  const long long need = (t / 128 + 7) / 8, full = (long long)sms * per_sm;
  hmap_mxu_v_ring<STAGES><<<(unsigned)(need < full ? need : full), 256, smem, st>>>(o, w, t, rho);
}
"""


def _columns(wide: bool):
    return [(MXU_KERNEL, MXU_COLUMNS + MXU_KERNEL),
            (MXU_LAUNCH, f"  hmap_mxu_v_columns<{str(wide).lower()}><<<(unsigned)blocks, 256, 0, "
                         "st>>>((int*)o, w, groups, rho);")]


def _ring(stages: int):
    return [(MXU_KERNEL, MXU_RING + MXU_KERNEL),
            (MXU_LAUNCH, f"  hmap_mxu_v_ring_launch<{stages}>(o, w, t, rho, st);")]


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
    "hmap_mxu": {
        "ahead1": (MXU, [(MXU_LOOP, MXU_LOOP.replace("unroll", "unroll 1"))], False),
        "ahead4": (MXU, [(MXU_LOOP, MXU_LOOP.replace("unroll", "unroll 4"))], False),
        "persistent": (MXU, [
            (MXU_GROUP, "  for (long long group = (long long)blockIdx.x * HMAP_MXU_WARPS + "
                        "(threadIdx.x >> 5);\n"
                        "       group < groups; "
                        "group += (long long)gridDim.x * HMAP_MXU_WARPS) {\n"),
            ("  }\n}\n\n// out, wxy:", "  }\n  }\n}\n\n// out, wxy:"),
            (MXU_LAUNCH, """  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hmap2_coords_mxu_kernel, 256, 0);
  const long long full = (long long)sms * per_sm;
  hmap2_coords_mxu_kernel<<<(unsigned)(blocks < full ? blocks : full), 256, 0, st>>>(
      o, w, groups, rho);""")], False),
        "fadd": (MXU, [(MXU_PRODUCT, """    hmap_mxu_dmma(
        __hiloint2double(0x43300000, v ^ (int)0x80000000) - 4503601774854144.0, b, &d0, &d1);
    if (k == 0)
      out[base + 8 * j] = make_int2(__double2loint(d0 + 6755399441055744.0),
                                    __double2loint(d1 + 6755399441055744.0));""")], False),
        "first_port": (MXU, _columns(False), False),
        "wide_loads": (MXU, _columns(True), False),
        "ring2": (MXU, _ring(2), False),
        "ring4": (MXU, _ring(4), False),
        "ring8": (MXU, _ring(8), False),
        "cuda_cores": (MXU, [(MXU_LOOP, MXU_FIRST),
                             (MXU_PRODUCT, """    const unsigned m = rho, q = qb;
    d0 = d1 = b * v;
    if (k == 0)
      out[base + 8 * j] = make_int2((int)(m * ((unsigned)w.x + q)),
                                    (int)(m * ((unsigned)w.y + 2u * q)));""")], False),
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


def mxu_cases(torch, dev, libs, cases, time_ms, failures) -> None:
    """The tensor-core map over the hmap2 grid of nb=16384 at rho=16, on
    an aligned input and on a view 8 bytes off a 16-byte boundary, the
    tree's output held against the plain version; and one ``copy_`` of the
    same bytes, the practical ceiling."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import hmap_mxu as TM

    nb, rho = 16384, 16
    wy, wx = torch.meshgrid(torch.arange(1, nb, device=dev), torch.arange(nb // 2, device=dev),
                            indexing="ij")
    store = torch.empty((wx.numel() + 1, 2), dtype=torch.int32, device=dev)
    store[1:, 0], store[1:, 1] = wx.reshape(-1), wy.reshape(-1)
    del wx, wy
    wxy = store[1:].clone()
    off = store[1:]
    _build._LIB = libs[("hmap_mxu", "tree")]
    for what, x in (("aligned", wxy), ("8 bytes off", off)):
        if not torch.equal(TM.HMAP_MXU.kernel(x, rho), TM.HMAP_MXU.plain(x, rho)):
            failures.append(f"hmap_mxu tree {what} against the plain version")
    torch.cuda.empty_cache()
    label = f"hmap_mxu nb={nb} rho={rho} T={len(wxy)}"
    cases("hmap_mxu", label, lambda: None, lambda _: TM.HMAP_MXU.kernel(wxy, rho))
    cases("hmap_mxu", f"{label} 8 bytes off", lambda: None,
          lambda _: TM.HMAP_MXU.kernel(off, rho), skip=("wide_loads", "ring2", "ring4", "ring8"))
    dst = torch.empty_like(wxy)
    ms = time_ms(lambda: dst.copy_(wxy))
    print(f"copy {label}: copy_ of {2 * wxy.numel() * 4} bytes ms={ms:.4f}", flush=True)


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
        source = {"ca3d": MD, "hmap_mxu": MXU}.get(kernel, L2D)
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
        info[key] = (diag, ptxas(log, "hmap" if key[0] == "hmap_mxu" else
                                 f"legacy_{key[0]}_kernel"))

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

    def cases(kernel, label, make, call, skip=()) -> None:
        """Time ``call(make())`` from each variant's library in turns; a
        ``call`` that returns a tensor returns its output."""
        keys = [k for k in libs if k[0] == kernel and k[1] not in skip]
        times = {k: [] for k in keys}
        ref, agree = None, {}
        for r in range(ROUNDS):
            for key in keys if r % 2 == 0 else keys[::-1]:
                _build._LIB = libs[key]
                out = make()
                res = call(out)
                out = out if res is None else res
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
        torch.cuda.empty_cache()
    if "hmap_mxu" in names:
        mxu_cases(torch, dev, libs, cases, time_ms, failures)
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
