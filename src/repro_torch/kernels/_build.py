"""Build and bind the CUDA kernels of ``kernels/csrc``.

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
compiles each ``.cu`` to an object in a few seconds; the objects are
compiled in parallel and linked into one shared library, which is loaded
with ``ctypes``.  The build runs at first use, keyed by a hash of the
sources and flags, into ``<repo>/build/repro_torch/<hash>/`` — a path
resolved from this file, not from the working directory.  Nothing here
runs at import time: hosts without ``nvcc`` import the package and use
the plain PyTorch versions on CPU tensors.

Every C entry returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.  Each object is compiled with
``-Xptxas -v``; what ptxas reports (registers, spills and shared memory
per kernel) is kept beside the library and read with ``build_log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Optional

__all__ = ["CSRC", "BUILD_ROOT", "CUDA_HOME", "NVCC_FLAGS", "library", "check", "nvcc_path",
           "build_log"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
CUDA_HOME = pathlib.Path("/usr/local/cuda")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
# Compile-only: ptxas prints each kernel's registers, spills and shared memory.
PTXAS_FLAGS = ("-Xptxas", "-v")
_LOG_NAME = "ptxas.log"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # out, header, data, threads, stream
    "simplex_map_launch": (_P, _P, _P, _I, _P),
    # dtype: a code of policy.DTYPE_CODES (csrc/dtypes.cuh)
    # x, dtype, header, data, n, rho, vec (16-byte pieces), stream
    "simplex_accum_launch": (_P, _I, _P, _P, _I, _I, _I, _P),
    # out, out dtype, float32 points, d, header, data, n, rho, stream
    "simplex_edm_launch": (_P, _I, _P, _I, _P, _P, _I, _I, _P),
    # out, in, dtype, periodic, vec (16-byte pieces), header, data, n, rho, stream
    "simplex_ca_launch": (_P, _P, _I, _I, _I, _P, _P, _I, _I, _P),
    # the float32 kernels (flash_attention.cu below 64-row tiles,
    # flash_wgmma.cu at 64 and 128): o, q, k, v, bias, bias_b, bias_h, seg,
    # b, hq, hkv, s, d, block_q, folded, scale, stream
    "flash_attention_launch": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                               _I, _F, _P),
    "flash_wgmma_launch": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                           _I, _F, _P),
    # the 16-bit wgmma kernel (flash16_wgmma.cu): as above with dtype 1
    # bfloat16 or 2 float16 before the stream
    "flash16_wgmma_launch": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _I, _P),
    # the stacked 16-bit kernel (flash16_stacked.cu): as flash16_wgmma_launch
    # with the warpgroups a block (1 or 2) before the stream
    "flash16_stacked_launch": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _I, _P),
    # the frozen 2-D originals (legacy2d.cu); kind 0 hmap, 1 rb, 2 bb
    # out, kind, nb, chunk, rows, stream
    "legacy_map2d_launch": (_P, _I, _I, _I, _L, _P),
    # x, dtype, kind, nb, n, rho, vec (16-byte pieces), stream
    "legacy_accum2d_launch": (_P, _I, _I, _I, _I, _I, _I, _P),
    # out, out dtype, float32 points, d, kind, nb, n, rho, vec (16-byte
    # pieces), stream
    "legacy_edm2d_launch": (_P, _I, _P, _I, _I, _I, _I, _I, _I, _P),
    # out, in, dtype, kind, nb, n, rho, vec (16-byte pieces), stream
    "legacy_ca2d_launch": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    # the frozen m >= 3 originals (legacy_md.cu)
    # x, dtype, header, data, n, rho, vec (16-byte pieces), stream
    "legacy_accum3d_launch": (_P, _I, _P, _P, _I, _I, _I, _P),
    "legacy_accum_md_launch": (_P, _I, _P, _P, _I, _I, _I, _P),
    # out, in, dtype, header, data, n, rho, vec (16-byte pieces), stream
    "legacy_ca3d_launch": (_P, _P, _I, _P, _P, _I, _I, _I, _P),
    # the tensor-core H map (hmap_mxu.cu): out, wxy, t, rho, stream
    "hmap2_coords_mxu_launch": (_P, _P, _L, _I, _P),
}

_LIB: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """The ``nvcc`` to build with: on PATH, else under /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = CUDA_HOME / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built on first use on a host "
        "with the CUDA toolkit; CPU tensors use the plain PyTorch versions"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_FLAGS).encode())
    cus, cuhs = _sources()
    for path in cus + cuhs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(target: pathlib.Path) -> None:
    nvcc = nvcc_path()
    cus, _ = _sources()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [pathlib.Path(tmp) / (cu.stem + ".o") for cu in cus]
        outs = [pathlib.Path(tmp) / (cu.stem + ".log") for cu in cus]
        t0 = time.monotonic()
        procs = []
        for cu, obj, out in zip(cus, objs, outs):
            with open(out, "w") as fh:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, *PTXAS_FLAGS, "-c", str(cu), "-o", str(obj)],
                    stdout=fh, stderr=subprocess.STDOUT))
        seconds = [0.0] * len(procs)
        while any(sec == 0.0 for sec in seconds):  # each object's own compile time
            for i, proc in enumerate(procs):
                if seconds[i] == 0.0 and proc.poll() is not None:
                    seconds[i] = max(time.monotonic() - t0, 1e-3)
            time.sleep(0.05)
        failed, log = [], []
        for cu, proc, out, sec in zip(cus, procs, outs, seconds):
            text = out.read_text()
            log.append(f"== {cu.name} ({sec:.1f} s)\n{text}")
            if proc.returncode != 0:
                failed.append(f"{cu.name}:\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        (target.parent / _LOG_NAME).write_text("".join(log))
        lib = pathlib.Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(lib)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib, target)  # atomic: concurrent builds agree


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use and then cached.

    Returns:
        The loaded ``ctypes.CDLL`` with ``argtypes``/``restype`` set.
    """
    global _LIB
    if _LIB is None:
        target = BUILD_ROOT / _digest() / "libsimplex_kernels.so"
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build_log() -> str:
    """What nvcc and ptxas printed when the library was built.

    One ``== <source>.cu (<seconds> s)`` line per object, with the
    seconds from the start of the build to the end of its compile (all
    compile at once), then its compiler output:
    for each kernel ptxas's ``Compiling entry function``, stack and
    spill line and ``Used N registers`` line.  Builds the library first
    if it is not built yet.
    """
    library()
    return (BUILD_ROOT / _digest() / _LOG_NAME).read_text()


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error.

    Args:
        code: The ``cudaError_t`` the entry returned.
        what: The kernel's name, for the message.
    """
    if code != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {code}")
