"""The 16-bit flash forward on warpgroup MMA (``csrc/flash16_wgmma.cu``,
its layouts and products in ``csrc/wgmma16.cuh``), its shared-memory
layouts and register fragments emulated on the CPU.

The kernel lands Q, K and V in shared memory as they are, in wgmma's
128-byte swizzle, and reads them through wgmma descriptors: Q and K as
K-major operands of S = Q K^T, V (stored ``[key][d]`` like K) as the
MN-major B operand of O += P V through the transpose-B immediate.  P goes
from the score accumulators to the A register fragment with no shuffle.
The emulation below takes its formulas from the kernel's source (the
swizzle of ``f16_swz``, the operand start offsets, the V descriptor's
start, LBO and SBO, the accumulator index of each A register) and
computes what the hardware reads through a descriptor:

* K-major, element ``(row, k)`` of a k16 step: ``start + (row // 8) * SBO
  + (row % 8) * 128 + 2k``;
* MN-major, element ``(k, n)``: ``start + (n // 64) * LBO + (k // 8) * SBO
  + (k % 8) * 128 + 2 (n % 64)``;

each then swizzled on the byte address as the 128-byte mode does
(bits 4-6 XOR bits 7-9; every operand sits on a 1024-byte boundary).

Held here: the emulated kernel, walking the same schedule with the same
64-key chunks and two-part P, against the plain version (one ulp of the
16-bit type plus ``2^-15 * max|v|``, the gate of ``test_torch_flash16``)
on random, bias and segment-masked tiles at every head dim the kernel is
built for; the accumulator-to-fragment identity exactly; and a wrong LBO
or a missing swizzle giving another product.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.kernels import flash_attention as RF
from repro_torch.kernels import flash_attention as TF
from test_torch_flash16 import _inputs, _segments, within_one_ulp

# The kernel and the header that holds its layout, descriptors and products.
SRC = "".join((pathlib.Path(TF.__file__).parent / "csrc" / name).read_text()
              for name in ("flash16_wgmma.cu", "wgmma16.cuh"))
DTYPES = (torch.bfloat16, torch.float16)


def _expr(pattern: str) -> str:
    """The C expression the pattern's group captures in the kernel."""
    found = re.search(pattern, SRC)
    assert found, pattern
    return " ".join(found.group(1).split())


def _fn(args: str, expr: str):
    """A C integer expression of ints as a Python function (the
    expressions below use only parentheses, ``* + >> << & ^``)."""
    return eval(f"lambda {args}: {expr}")  # noqa: S307 - the kernel's own formula


BN = int(_expr(r"#define F16_BN (\d+)"))
# The swizzled byte offset of 16-byte piece c of row r (f16_swz).
SWZ = _fn("r, c, rows", _expr(r"int f16_swz\(int r, int c, int rows\) \{\s*return (.*?);"))
# The start of k-step ks of warpgroup wg's rows of Q (QROWS rows: the
# kernel's BQ), and of a K chunk.
Q_START = _fn("ks, wg, QROWS", _expr(r"const int qo = (.*?);"))
K_START = _fn("ks, F16_BN", _expr(r"const int ko = (.*?);"))
# The V descriptor of 16-key step j: its start and its LBO; SBO is f16_desc's.
V_START = _fn("j", _expr(r"f16_desc\(vc \+ (.*?), .*?\)"))
V_LBO = _fn("F16_BN", _expr(r"f16_desc\(vc \+ .*?, (.*?)\)"))(BN)
SBO = int(_expr(r"\(uint64_t\)\((\d+) >> 4\) << 32"))
# The score accumulator that register f of k-step j packs (and the next one).
A_FROM_ACC = _fn("j, f", _expr(r"split2\(sc\[(.*?)\], sc\[.*?\], hi\[j\]\[f\]"))


def test_kernel_has_the_emulated_layouts():
    """Three anchors: the formulas above came out of the source, the PV
    wgmmas read B transposed (immediate 1) while S reads both operands
    K-major, and P's second element of a register is the next accumulator."""
    assert BN == 64 and SBO == 1024 and V_LBO == 64 * 128
    assert SWZ(9, 10, 64) == 64 * 128 + 9 * 128 + ((2 ^ 1) << 4)
    assert re.search(r"\}, %32, %33, p, 1, 1, 0, 0;", SRC)
    assert len(re.findall(r"\}, \{%\d+, %\d+, %\d+, %\d+\}, %\d+, p, 1, 1, 1;", SRC)) == 2
    second = _fn("j, f", _expr(r"split2\(sc\[.*?\], sc\[(.*?)\], hi\[j\]\[f\]"))
    assert all(second(j, f) == A_FROM_ACC(j, f) + 1 for j in range(4) for f in range(4))


# ---------------------------------------------------------------- the hardware's reads


def swizzle128(addr: np.ndarray) -> np.ndarray:
    """The 128-byte swizzle on a byte address: bits 4-6 ^= bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def land(x: torch.Tensor, swizzle: bool = True) -> np.ndarray:
    """A ``(rows, d)`` 16-bit tile as the kernel lands it: piece ``c`` of
    row ``r`` (8 elements) at ``f16_swz(r, c, rows)``, in a buffer of
    ``ceil(d / 64)`` atoms of ``rows * 128`` bytes (as uint16).  Without
    the swizzle, piece c of row r lands at its natural place."""
    rows, d = x.shape
    bits = x.view(torch.int16).numpy().view(np.uint16)
    buf = np.zeros(((d + 63) // 64) * rows * 64, np.uint16)
    r, c = np.meshgrid(np.arange(rows), np.arange(d // 8), indexing="ij")
    off = SWZ(r, c, rows) if swizzle else (c >> 3) * rows * 128 + r * 128 + ((c & 7) << 4)
    for e in range(8):
        buf[(off + 2 * e) // 2] = bits[r, 8 * c + e]
    return buf


def read_kmajor(buf: np.ndarray, start: int, rows: int) -> np.ndarray:
    """One k16 step of a K-major operand through its descriptor
    (SBO between 8-row groups): ``(rows, 16)`` uint16."""
    m, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    addr = start + (m // 8) * SBO + (m % 8) * 128 + 2 * k
    return buf[swizzle128(addr) // 2]


def read_mnmajor(buf: np.ndarray, start: int, lbo: int, n_cols: int) -> np.ndarray:
    """One k16 step of an MN-major B operand (``(16, n_cols)`` uint16):
    LBO between the 64-column atoms along N, SBO between 8-row groups
    along K."""
    k, n = np.meshgrid(np.arange(16), np.arange(n_cols), indexing="ij")
    addr = start + (n // 64) * lbo + (k // 8) * SBO + (k % 8) * 128 + 2 * (n % 64)
    return buf[swizzle128(addr) // 2]


def values(bits: np.ndarray, dtype) -> torch.Tensor:
    """uint16 bits of ``dtype`` as float64 values."""
    return torch.from_numpy(bits.view(np.int16).copy()).view(dtype).to(torch.float64)


def a_fragments(p: torch.Tensor, j: int) -> torch.Tensor:
    """The A operand (64 x 16) of 16-key step j as the warpgroup's
    registers hold it: warp w, lane (g, t), register f, half h is row
    ``16w + g + 8 (f % 2)``, k ``2t + h + 8 (f // 2)``, taken from score
    accumulator ``i = A_FROM_ACC(j, f) + h``, which holds row
    ``16w + g + 8 ((i // 2) % 2)``, key ``8 (i // 4) + 2t + i % 2``."""
    a = torch.full((64, 16), float("nan"), dtype=p.dtype)
    w, g, t = np.meshgrid(np.arange(4), np.arange(8), np.arange(4), indexing="ij")
    for f in range(4):
        for h in range(2):
            i = A_FROM_ACC(j, f) + h
            acc_row = 16 * w + g + 8 * ((i // 2) % 2)
            acc_key = 8 * (i // 4) + 2 * t + i % 2
            a[16 * w + g + 8 * (f % 2), 2 * t + h + 8 * (f // 2)] = p[acc_row, acc_key]
    return a


def parts(p: torch.Tensor, dtype):
    """P's two 16-bit parts (as float64): hi = round(P), lo = round(P - hi)."""
    hi = p.to(dtype)
    lo = (p - hi.to(p.dtype)).to(dtype)
    return hi.to(torch.float64), lo.to(torch.float64)


def wgmma16_emulation(q, k, v, block_q, scale, bias=None, seg=None, kind="folded",
                      lbo=V_LBO, swizzle=True):
    """The kernel's walk: per (b*Hq) slab and query tile, Q landed once,
    then 64-key chunks of K and V landed in the swizzle; per warpgroup
    S = Q K^T from the K-major reads (exact 16-bit products, float64
    sums), scale, bias and masks, the online max and sum in float32,
    O rescaled, then O += lo V + hi V with P's parts in the A fragment
    layout and V from the MN-major reads; the output rounded once."""
    dtype = q.dtype
    b, hq, s, d = q.shape
    grp = hq // k.shape[1]
    nq = s // block_q
    ncols = ((d + 63) // 64) * 64
    out = torch.zeros_like(q)
    for bh in range(b * hq):
        bi, h = divmod(bh, hq)
        kk, vv = k[bi, h // grp], v[bi, h // grp]
        rows = range((nq + 1) // 2) if kind == "folded" else range(nq)
        for p in rows:
            for qt, kt, start, last in TF._schedule(kind, nq, p):
                rq = torch.arange(qt * block_q, (qt + 1) * block_q)
                if start:
                    qbuf = land(q[bi, h, rq], swizzle)
                    m = torch.full((block_q,), TF.NEG_INF)
                    l = torch.zeros(block_q)
                    acc = torch.zeros((block_q, ncols), dtype=torch.float64)
                for c0 in range(kt * block_q, (kt + 1) * block_q, BN):
                    rk = torch.arange(c0, c0 + BN)
                    kbuf, vbuf = land(kk[rk], swizzle), land(vv[rk], swizzle)
                    for wg in range(block_q // 64):
                        rw = slice(64 * wg, 64 * wg + 64)
                        sc = torch.zeros((64, BN), dtype=torch.float64)
                        for ks in range(d // 16):
                            a = values(read_kmajor(qbuf, Q_START(ks, wg, block_q), 64), dtype)
                            bk = values(read_kmajor(kbuf, K_START(ks, BN), BN), dtype)
                            sc += a @ bk.T
                        sc = sc.to(torch.float32) * scale
                        rows_g, keys_g = rq[rw], rk
                        if bias is not None:
                            sc = sc + bias[bi % bias.shape[0], h % bias.shape[1]][rows_g][:, keys_g]
                        ok = keys_g[None, :] <= rows_g[:, None]
                        if seg is not None:
                            ok = ok & (seg[bi, rows_g][:, None] == seg[bi, keys_g][None, :])
                        sc = torch.where(ok, sc, TF.NEG_INF)
                        mn = torch.maximum(m[rw], sc.amax(1))
                        alpha = torch.exp(m[rw] - mn)
                        pr = torch.where(ok, torch.exp(sc - mn[:, None]), 0.0)
                        l[rw] = l[rw] * alpha + pr.sum(1)
                        m[rw] = mn
                        acc[rw] *= alpha[:, None].double()
                        for j in range(BN // 16):
                            hi, lo = parts(a_fragments(pr, j), dtype)
                            bv = values(read_mnmajor(vbuf, V_START(j), lbo, ncols), dtype)
                            acc[rw] += lo @ bv + hi @ bv
                if last:
                    res = acc[:, :d].to(torch.float32) / torch.where(l == 0, 1.0, l)[:, None]
                    out[bi, h, rq] = res.to(dtype)
    return out


# ---------------------------------------------------------------- the checks


def test_accumulators_are_the_a_fragments():
    """The f32 accumulator of n-tiles 2j and 2j+1 is the A fragment of
    k-step j as it stands: every register reads P[:, 16j:16j+16] exactly."""
    p = torch.arange(64 * BN, dtype=torch.float64).reshape(64, BN)
    for j in range(BN // 16):
        assert torch.equal(a_fragments(p, j), p[:, 16 * j:16 * j + 16])


@pytest.mark.parametrize("d", TF.KERNEL_HEAD_DIMS)
def test_landed_tiles_read_back_through_the_descriptors(d):
    """Q and K read K-major, and V read MN-major, give back the tiles."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((128, d)).astype(np.float32)).to(torch.bfloat16)
    buf = land(x)
    got = np.concatenate([read_kmajor(buf, Q_START(ks, 1, 128), 64) for ks in range(d // 16)], 1)
    assert torch.equal(values(got, torch.bfloat16), x[64:].double())
    vx = x[:BN]
    vbuf = land(vx)
    ncols = ((d + 63) // 64) * 64
    got = np.concatenate([read_mnmajor(vbuf, V_START(j), V_LBO, ncols) for j in range(BN // 16)])
    assert torch.equal(values(got, torch.bfloat16)[:, :d], vx.double())


# (block_q, tile kind, schedule kind)
EMULATED = [(64, "random", "folded"), (128, "bias", "folded"), (64, "masked", "bb")]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda t: str(t).split(".")[-1])
@pytest.mark.parametrize("d", TF.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("block_q,tile,kind", EMULATED)
def test_emulated_kernel_within_one_ulp_of_plain(block_q, tile, kind, d, dtype):
    b, hq, hkv = 1, 2, 1
    s = 3 * block_q
    _, (q, k, v) = _inputs(b, hq, hkv, s, d, dtype, seed=block_q + d)
    rng = np.random.default_rng(d + 7)
    bias = (torch.from_numpy(rng.standard_normal((1, hq, s, s)).astype(np.float32))
            if tile == "bias" else None)
    seg = torch.from_numpy(_segments(b, s)) if tile == "masked" else None
    scale = d**-0.5
    got = wgmma16_emulation(q, k, v, block_q, scale, bias, seg, kind)
    want = TF.FLASH.plain(kind, block_q, scale, q, k, v, bias, seg)
    assert got.dtype == want.dtype == dtype
    within_one_ulp(got, want, dtype, v.abs().max().item())


def test_plain_matches_jax_at_a_wgmma_tile():
    """The plain version the emulation is held to, against the JAX
    package's kernel in interpret mode at a 64-row bf16 tile."""
    (qn, kn, vn), (q, k, v) = _inputs(1, 2, 1, 128, 64, torch.bfloat16, seed=3)
    got = TF.flash_attention(q, k, v, block_q=64, block_kv=64, device="cpu")
    want = RF.flash_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), block_q=64,
                              block_kv=64, interpret=True)
    within_one_ulp(got, torch.from_numpy(np.asarray(want).astype(np.float32)), torch.bfloat16,
                   v.abs().max().item())


@pytest.mark.parametrize("fault", ["lbo", "swizzle"])
def test_a_wrong_layout_gives_another_product(fault):
    """The emulation can fail: V's atoms read at a wrong LBO (the SBO's
    value), or tiles landed without the swizzle, move the output far
    beyond the gate."""
    d, block_q = 128, 64
    _, (q, k, v) = _inputs(1, 2, 1, 128, d, torch.bfloat16, seed=11)
    want = TF.FLASH.plain("folded", block_q, d**-0.5, q, k, v)
    kw = {"lbo": SBO} if fault == "lbo" else {"swizzle": False}
    got = wgmma16_emulation(q, k, v, block_q, d**-0.5, **kw)
    assert (got.float() - want.float()).abs().max().item() > 0.1
