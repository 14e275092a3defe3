"""The tensor-core arithmetic of ``edm.cu``, ``flash_attention.cu`` and
``flash_wgmma.cu``, emulated on the CPU and held against the plain
versions; ``flash_wgmma.cu``'s shared-memory layouts emulated against the
fragments they replace.

Both kernels take float32 dot products on the tensor cores as 3xTF32
``mma.sync`` (``kernels/csrc/mma_tf32.cuh``): ``x = big + small`` with
``big = tf32(x)`` and ``small = tf32(x - big)``, where ``tf32`` is
``cvt.rna.tf32.f32`` (round to nearest, ties away from zero, to 10
explicit mantissa bits), and ``a.b ~ big_a.big_b + big_a.small_b +
small_a.big_b``.  A product of two TF32 values is exact in float32, so
float32 matrix products of the parts emulate the MMAs up to the order of
the float32 sums.

The gates are the card's: EDM within ``1e-5 + 1e-5 * max|want|`` and
flash within ``2e-5 + 2e-5 * max|want|`` of the plain version.  Single-
pass TF32 (``big_a.big_b`` alone) must fail the EDM gate on the same
inputs, which shows the test sees the difference.
"""

import pathlib

import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.kernels import ref as RR
from repro_torch.kernels import engine as TE
from repro_torch.kernels import flash_attention as TF

GUARD = 0.5  # EDM_GUARD in edm.cu


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the
    magnitude (ties away from zero), then clear them."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def mma3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in 3xTF32: the two small products, then big.big."""
    ab, asm = split(a)
    bb, bsm = split(b)
    return (asm @ bb + ab @ bsm) + ab @ bb


def mma1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in single-pass TF32."""
    return tf32(a) @ tf32(b)


def gram_distances(p: torch.Tensor, product) -> torch.Tensor:
    """All pair distances as ``edm.cu`` takes them: the Gram form
    ``|a|^2 + |b|^2 - 2 a.b`` with ``product`` for ``a.b`` and float32
    norms, and the difference form below ``GUARD * (|a|^2 + |b|^2)``."""
    nrm = (p * p).sum(1)
    tot = nrm[:, None] + nrm[None, :]
    s = tot - 2 * product(p, p.T)
    diff = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    return torch.sqrt(torch.where(s < GUARD * tot, diff, s))


def _gate(got, want, rel, what):
    err = (got - want).abs().max().item()
    tol = rel + rel * want.abs().max().item()
    assert np.isfinite(err) and err <= tol, f"{what}: max_abs_err={err} > {tol}"
    return err, tol


def _points(n, d, seed, kind="random"):
    """Gaussian points; ``duplicates`` adds exact and near-duplicate rows,
    ``cluster`` a tight cluster far from the origin (|p|^2 ~ 1e4 d, pair
    distances ~ 1e-3), where the Gram form cancels almost entirely."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, d)).astype(np.float32)
    if kind == "duplicates":
        p[1::4] = p[0::4][: len(p[1::4])]
        near = p[0::4][: len(p[2::4])]
        p[2::4] = near + 1e-4 * rng.standard_normal(near.shape).astype(np.float32)
    elif kind == "cluster":
        p[3::4] = 100.0 + 1e-3 * p[3::4]
    return p


def test_tf32_rounding():
    one = torch.tensor([1.0, -1.0], dtype=torch.float32)
    half = 2.0**-11  # half of the TF32 ulp at 1: a tie, rounded away from zero
    x = torch.cat([one * (1 + half), one * (1 + half / 2), one * (1 + 3 * half)])
    want = torch.tensor([1 + 2 * half, -(1 + 2 * half), 1, -1, 1 + 4 * half, -(1 + 4 * half)])
    assert torch.equal(tf32(x), want.to(torch.float32))
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 1e3)
    big, small = split(v)
    assert torch.all((big.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((small.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((big - v).abs() <= 2.0**-11 * v.abs())
    assert torch.all((big.double() + small.double() - v.double()).abs() <= 2.0**-21 * v.abs())


@pytest.mark.parametrize("kind", ["random", "duplicates", "cluster"])
@pytest.mark.parametrize("d", [5, 64])
def test_edm_gram_3xtf32_holds_the_gate(d, kind):
    n, rho = 64, 8
    p = _points(n, d, seed=d, kind=kind)
    want = TE.edm(p, 2, rho=rho, kind="hmap", device="cpu")
    got = gram_distances(torch.from_numpy(p), mma3).tril()
    _gate(got, want, 1e-5, f"3xTF32 d={d}")
    # The oracle of the JAX package agrees on the same points.
    np.testing.assert_allclose(got.numpy(), np.asarray(RR.edm_md(p, 2)), rtol=1e-5, atol=1e-5)
    assert torch.all(torch.diagonal(got) == 0)  # c_a == c_b: 0 through the guard
    if kind == "duplicates":  # so do the duplicate rows
        assert torch.all(got[1::4, 0::4].diagonal() == 0)


@pytest.mark.parametrize("kind", ["random", "duplicates"])
def test_edm_single_pass_tf32_fails_the_gate(kind):
    """The inputs of the 3xTF32 cases at d = 64 (seed 64)."""
    p = _points(64, 64, seed=64, kind=kind)
    want = TE.edm(p, 2, rho=8, kind="hmap", device="cpu")
    got = gram_distances(torch.from_numpy(p), mma1).tril()
    err = (got - want).abs().max().item()
    assert err > 1e-5 + 1e-5 * want.abs().max().item()


def test_edm_guard_is_needed_at_duplicates():
    """Without the guard the Gram form leaves a visible distance between a
    point and itself; the guard takes it to 0."""
    pt = torch.from_numpy(_points(64, 64, seed=2, kind="duplicates"))
    nrm = (pt * pt).sum(1)
    s = nrm[:, None] + nrm[None, :] - 2 * mma3(pt, pt.T)
    raw = torch.sqrt(s.clamp(min=0)).diagonal()
    assert raw.max().item() > 1e-5 + 1e-5 * gram_distances(pt, mma3).max().item()
    assert torch.all(gram_distances(pt, mma3).diagonal() == 0)


def test_edm_m3_pair_sums_hold_the_gate():
    n, rho = 24, 4
    p = _points(n, 16, seed=3, kind="duplicates")
    dist = gram_distances(torch.from_numpy(p), mma3)
    i, j, k = torch.meshgrid(*(torch.arange(n),) * 3, indexing="ij")
    # Axis j holds x_{m-1-j}; the pair sum in the reference's order.
    got = (dist[k, j] + dist[k, i]) + dist[j, i]
    dom = (i + j + k) < n
    want = TE.edm(p, 3, rho=rho, kind="octant", device="cpu")
    _gate(torch.where(dom, got, 0.0), want, 1e-5, "m=3")


def flash_tile_emulation(q, k, v, block_q, scale, bias=None, seg=None, kind="folded"):
    """The kernel's recurrence: per query tile, KV sub-chunks of
    ``min(16, block_q)`` keys, ``S = mma3(Q, K^T)`` with bias and masks on
    the scores, the online max and sum, ``O = alpha O + mma3(P, V)``."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    nq, bc = s // block_q, min(16, block_q)
    out = torch.zeros_like(q)
    for bh in range(b * hq):
        bi, h = divmod(bh, hq)
        qs = q[bi, h] * scale
        kk, vv = k[bi, h // g], v[bi, h // g]
        rows = range((nq + 1) // 2) if kind == "folded" else range(nq)
        for p in rows:
            for qt, kt, start, last in TF._schedule(kind, nq, p):
                if start:
                    m = torch.full((block_q,), TF.NEG_INF)
                    l = torch.zeros(block_q)
                    acc = torch.zeros(block_q, d)
                rq = torch.arange(qt * block_q, (qt + 1) * block_q)
                for c0 in range(kt * block_q, (kt + 1) * block_q, bc):
                    rk = torch.arange(c0, c0 + bc)
                    sc = mma3(qs[rq], kk[rk].T)
                    if bias is not None:
                        sc = sc + bias[bi % bias.shape[0], h % bias.shape[1]][rq][:, rk]
                    ok = rk[None, :] <= rq[:, None]
                    if seg is not None:
                        ok = ok & (seg[bi, rq][:, None] == seg[bi, rk][None, :])
                    sc = torch.where(ok, sc, TF.NEG_INF)
                    mn = torch.maximum(m, sc.amax(1))
                    alpha = torch.exp(m - mn)
                    pr = torch.where(ok, torch.exp(sc - mn[:, None]), 0.0)
                    l = l * alpha + pr.sum(1)
                    acc = acc * alpha[:, None] + mma3(pr, vv[rk])
                    m = mn
                if last:
                    out[bi, h, rq] = acc / torch.where(l == 0, 1.0, l)[:, None]
    return out


@pytest.mark.parametrize(
    "block_q,with_bias,with_seg,kind",
    [(16, False, False, "folded"), (64, True, False, "folded"), (32, True, True, "bb"),
     (16, False, True, "folded")],
)
def test_flash_3xtf32_recurrence_holds_the_gate(block_q, with_bias, with_seg, kind):
    b, hq, hkv, s, d = 2, 4, 2, 128, 32
    rng = np.random.default_rng(block_q)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    bias = (torch.from_numpy(rng.standard_normal((1, hq, s, s)).astype(np.float32))
            if with_bias else None)
    seg = None
    if with_seg:  # a later segment starts inside a tile: its rows see masked keys first
        seg = torch.zeros((b, s), dtype=torch.int32)
        seg[0, s // 3:] = 1
        seg[1, (2 * s) // 3 + 5:] = 2
    scale = d**-0.5
    got = flash_tile_emulation(q, k, v, block_q, scale, bias, seg, kind)
    want = TF.FLASH.plain(kind, block_q, scale, q, k, v, bias, seg)
    _gate(got, want, 2e-5, f"flash block_q={block_q}")
    assert torch.isfinite(got).all()


def test_flash_fully_masked_rows_give_zero():
    """Segment ids that no key of a row shares: l stays 0, the output 0."""
    b, hq, s, d = 1, 2, 64, 16
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, hq, s, d)).astype(np.float32))
               for _ in range(3))
    seg = torch.arange(s, dtype=torch.int32)[None].clone()
    seg[0, 1::2] = -1  # odd rows: only themselves visible; even rows likewise
    got = flash_tile_emulation(q, k, v, 16, d**-0.5, None, seg)
    want = TF.FLASH.plain("folded", 16, d**-0.5, q, k, v, None, seg)
    _gate(got, want, 2e-5, "masked rows")
    nothing = torch.full((b, s), 7, dtype=torch.int32)
    nothing[0, : s // 2] = torch.arange(s // 2)
    empty = flash_tile_emulation(q, k, v, 16, d**-0.5, None, nothing)
    assert torch.isfinite(empty).all()


def test_new_layouts_accept_every_shape_the_old_ones_did():
    """``edm.cu``'s warp slice fits wherever the one-block layout it
    replaced (rows of d+1 floats plus every pair's distance matrix) fit,
    and the flash kernel still fits every tile it is built for."""
    limit = TF.SMEM_LIMIT
    for m in range(2, 9):
        pairs = m * (m - 1) // 2
        for rho in (1, 2, 3, 4, 5, 8, 16, 24, 32, 64, 128, 200):
            for d in (1, 2, 3, 4, 5, 7, 8, 63, 64, 65, 127, 1000, 7000, 30000):
                old = 4 * (m * rho * (d + 1) + pairs * rho * rho)
                new = TE.EDMBody.smem_bytes(m, rho, d)
                if old <= limit:
                    assert new <= limit, (m, rho, d, old, new)
    assert all(TF.kernel_fits(bq, d) for bq in TF.KERNEL_BLOCKS for d in TF.KERNEL_HEAD_DIMS)


# ---------------------------------------------------------------- flash_wgmma.cu's layouts
#
# flash_wgmma.cu splits each operand once per block and stores the parts
# in wgmma's 128-byte-swizzle K-major layout: 8 rows of 128 bytes an atom,
# the 16-byte piece c of row r at piece c ^ (r % 8), atoms along K; the
# hardware reads k-step ks (8 floats) of row r from bytes 32 (ks % 4) ..
# of atom ks // 4, through the same XOR.  V is stored transposed, its keys
# permuted within each 8-key block so that the score accumulators are the
# A fragment of the PV product as they stand.  The emulation below holds
# those formulas, which the test first finds in the kernel's source.

WGMMA_SRC = (pathlib.Path(TF.__file__).parent / "csrc" / "flash_wgmma.cu").read_text()


def wg_swz(r: int, c: int, rows: int) -> int:
    """Byte offset of 16-byte piece ``c`` of row ``r`` (``wg_swz``)."""
    return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4)


def wg_read(buf: np.ndarray, r: int, ks: int, kk: int, rows: int) -> np.uint32:
    """What wgmma reads for row ``r``, element ``kk`` of k-step ``ks``: the
    logical byte 32 (ks % 4) + 4 kk of the row in atom ks // 4, whose
    16-byte piece the hardware swizzles by the row."""
    byte = 32 * (ks & 3) + 4 * kk
    piece, within = byte >> 4, byte & 15
    addr = (ks >> 2) * rows * 128 + r * 128 + ((piece ^ (r & 7)) << 4) + within
    return buf[addr // 4]


def split_bits(x: torch.Tensor):
    big, small = split(x)
    return big.view(torch.int32).numpy().view(np.uint32), \
        small.view(torch.int32).numpy().view(np.uint32)


def test_wgmma_kernel_has_the_emulated_layouts():
    """Two anchors tie the emulations below to the kernel: the swizzle of
    ``wg_swz`` and the key permutation of the Vᵀ split pass."""
    for text in ("(c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4)",
                 "(8 * (j >> 1) + (j & 1)) * D"):
        assert text in WGMMA_SRC, text


@pytest.mark.parametrize("rows,d", [(128, 128), (64, 64), (32, 16)])
def test_block_once_split_gives_the_fragment_bits(rows, d):
    """Q (scaled) and K split once into the swizzled layout read back, at
    every (row, k) wgmma asks for, the big and small bits ``frag_a`` /
    ``frag_b`` give when they split the same value at the load; so does
    the register A fragment of Q's big part, read from the same layout."""
    rng = np.random.default_rng(rows + d)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)) * d**-0.5
    atoms = (d + 31) // 32
    bufs = [np.zeros(atoms * rows * 32, np.uint32) for _ in range(2)]
    for r in range(rows):  # the split pass: piece c4 of row r, both parts
        for c4 in range(d // 4):
            off = wg_swz(r, c4, rows) // 4
            for part, bits in zip(bufs, split_bits(x[r, 4 * c4:4 * c4 + 4])):
                part[off:off + 4] = bits
    big, small = split_bits(x)
    for ks in range(d // 8):
        for r in range(rows):
            for kk in range(8):
                assert wg_read(bufs[0], r, ks, kk, rows) == big[r, 8 * ks + kk]
                assert wg_read(bufs[1], r, ks, kk, rows) == small[r, 8 * ks + kk]
    # The register A fragment of Q's big part, read once per query tile:
    # lane (g, t) of warp w holds rows 16w + g (+8), k-step columns t, t+4.
    for w in range(rows // 16):
        for g in range(8):
            for t in range(4):
                for ks in range(d // 8):
                    for f in range(4):
                        r = 16 * w + g + 8 * (f & 1)
                        k = 8 * ks + t + 4 * (f >> 1)
                        off = (wg_swz(r, k >> 2, rows) + 4 * (k & 3)) // 4
                        assert bufs[0][off] == big[r, k]


def _vt_buffers(v: torch.Tensor, permute: bool):
    """V (32 keys x D) split into V^T's two parts as the split pass writes
    them: row d, logical keys 4j..4j+3 from physical keys
    8 (j / 2) + (j % 2) + {0, 2, 4, 6} (or, without the permutation,
    4j..4j+3)."""
    n, d = v.shape
    bufs = [np.zeros(d * 32, np.uint32) for _ in range(2)]
    for dd in range(d):
        for j in range(n // 4):
            keys = ([8 * (j >> 1) + (j & 1) + o for o in (0, 2, 4, 6)] if permute
                    else [4 * j + o for o in range(4)])
            off = (dd * 128 + ((j ^ (dd & 7)) << 4)) // 4
            for part, bits in zip(bufs, split_bits(v[keys, dd])):
                part[off:off + 4] = bits
    return bufs


def _pv_from_accumulators(p: torch.Tensor, bufs, d: int) -> torch.Tensor:
    """One warp's O = P V as the kernel issues it: P (16 x 32) held as the
    score accumulators (lane (g, t): sc[4i + e] = P[g + 8 (e / 2)]
    [8i + 2t + (e % 2)]), taken as the A fragment of k-step i (a0 = (g, t)
    = sc[4i], a1 = (g + 8, t) = sc[4i + 2], a2 = (g, t + 4) = sc[4i + 1],
    a3 = (g + 8, t + 4) = sc[4i + 3]), times B = V^T read by wgmma, in
    3xTF32 with every product and sum in float64."""
    pb, ps = split(p)
    out = torch.zeros((16, d), dtype=torch.float64)
    for i in range(4):
        a_big = torch.zeros((16, 8), dtype=torch.float64)
        a_small = torch.zeros((16, 8), dtype=torch.float64)
        for g in range(8):
            for t in range(4):
                for (row, k), (r_acc, key) in (((g, t), (g, 8 * i + 2 * t)),
                                               ((g + 8, t), (g + 8, 8 * i + 2 * t)),
                                               ((g, t + 4), (g, 8 * i + 2 * t + 1)),
                                               ((g + 8, t + 4), (g + 8, 8 * i + 2 * t + 1))):
                    a_big[row, k] = pb[r_acc, key]
                    a_small[row, k] = ps[r_acc, key]
        b = [np.array([[wg_read(part, n, i, k, d) for n in range(d)] for k in range(8)])
             for part in bufs]
        b_big, b_small = (torch.from_numpy(x.astype(np.uint32).view(np.float32)).double()
                          for x in b)
        out += a_small @ b_big + a_big @ b_small + a_big @ b_big
    return out


@pytest.mark.parametrize("d", [16, 128])
def test_vt_layout_gives_the_same_product(d):
    """The permuted V^T with the accumulators as A gives P V's 3xTF32
    product exactly (every term exact in float64); without the
    permutation the same reads give another matrix."""
    rng = np.random.default_rng(d)
    p = torch.from_numpy(rng.random((16, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((32, d)).astype(np.float32))
    pb, ps = split(p)
    vb, vs = split(v)
    want = ps.double() @ vb.double() + pb.double() @ vs.double() + pb.double() @ vb.double()
    got = _pv_from_accumulators(p, _vt_buffers(v, permute=True), d)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    wrong = _pv_from_accumulators(p, _vt_buffers(v, permute=False), d)
    assert (wrong - want).abs().max().item() > 1e-3
