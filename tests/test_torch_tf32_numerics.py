"""The tensor-core arithmetic of ``edm.cu`` and ``flash_attention.cu``,
emulated on the CPU and held against the plain versions.

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

import numpy as np
import pytest
import torch

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
