"""Flash attention in bfloat16 and float16, held on the CPU.

The reference's Pallas kernel takes q's dtype and computes in float32
inside: q, k and v are upcast, the scores, the softmax and P stay
float32, and only the output is rounded to q's dtype.  On the card the
port's 16-bit kernels (``flash16``, ``csrc/flash16_stacked.cu``, below
64-row tiles; ``flash16_wgmma`` at 64 and 128) keep that arithmetic on
the 16-bit tensor cores: S = Q K^T is one MMA in the input
type (the products of two 16-bit values are exact in float32), and P is
split into two parts of the input type, ``hi = round(P)`` and
``lo = round(P - hi)``, so that O += lo V + hi V keeps P float32-accurate.

Here:

* the plain version at bf16 and f16 against the JAX package's kernel in
  interpret mode, and the reduced yi-6b prefill at the config's own
  ``act_dtype`` (bfloat16) against the JAX model with the same weights
  (``params_from_jax``);
* an emulation of the 16-bit arithmetic's recurrence over key
  sub-chunks smaller than a tile (exact 16-bit products summed in
  float32, the two-part P) against the plain version, and the two-part P
  product against float32 P, beside a single 16-bit rounding of P on the
  same tiles (the kernels' own walks are emulated in
  ``test_torch_flash16_wgmma.py`` and ``test_torch_flash16_stacked.py``).

Gates, with their reasons:

* outputs within one output ulp (of the larger of the two values) plus
  ``2**-15 * max|V|``: both sides compute float32 values that differ by
  the order of float32 sums (at most about ``2**-18 * max|V|`` over a
  row of these lengths, since the row's weights sum to 1) and, in the
  kernel's arithmetic, by P's two-part split (``2**-16`` of each P for
  bf16, ``2**-22`` for f16), then round once to the 16-bit type.  Where
  no cancellation shrinks an output below that allowance, this is one
  output ulp;
* the bf16 prefill's logits within ``2**-5 * max|logit|`` (four bf16
  ulps of the largest logit): the port and the JAX model round the
  residual stream, the attention inputs and the MLP to bfloat16 at their
  own points (the two frameworks do), and through two layers and the
  unembedding those roundings move a logit by about one ulp of bf16.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.configs.ALL import REDUCED as R_REDUCED
from repro.kernels import flash_attention as RF
from repro.models.model import Model as RModel
from repro_torch.autotune import tuner as TT
from repro_torch.configs.ALL import REDUCED
from repro_torch.kernels import flash_attention as TF
from repro_torch.models.convert import params_from_jax

DTYPES = (torch.bfloat16, torch.float16)
NP = {torch.bfloat16: ml_dtypes.bfloat16, torch.float16: np.float16}
# Explicit mantissa bits and least normal exponent of each type.
FMT = {torch.bfloat16: (7, -126), torch.float16: (10, -14)}


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


def _name(t):
    return str(t).split(".")[-1]


def ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype`` at |x| (its subnormal spacing below the
    normal range)."""
    p, emin = FMT[dtype]
    _, e = torch.frexp(x.to(torch.float32).abs())
    return torch.ldexp(torch.ones(x.shape), (e - 1).clamp(min=emin) - p)


def within_one_ulp(got: torch.Tensor, want: torch.Tensor, dtype, vmax: float) -> float:
    """Asserts |got - want| <= one ulp of the larger value plus
    ``2**-15 * vmax`` (the module's gate); returns the largest
    |got - want| in ulps of the larger value."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    one = torch.maximum(ulp(g, dtype), ulp(w, dtype))
    err = (g - w).abs()
    assert bool(torch.isfinite(err).all()), "not finite"
    over = (err - one - 2.0**-15 * vmax).max().item()
    assert over <= 0, f"{over} beyond the gate"
    return (err / one).max().item()


def _inputs(b, hq, hkv, s, d, dtype, seed):
    """q, k, v as numpy arrays of the 16-bit type (made in float32 from a
    seed) and as torch tensors holding the same values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(sh).astype(np.float32).astype(NP[dtype])
            for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]
    return arrs, [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrs]


def _segments(b, s):
    seg = np.zeros((b, s), np.int32)
    seg[0, s // 3:] = 1
    seg[-1, (2 * s) // 3 + 5:] = 2
    return seg


# (kind, b, hq, hkv, s, d, block, bias lead dims, segments)
CASES = [
    ("folded", 1, 4, 2, 64, 16, 16, None, False),
    ("bb", 1, 4, 2, 64, 16, 16, (1, 4), True),
    ("folded", 2, 2, 2, 48, 32, 16, (2, 1), False),
    ("folded", 1, 2, 1, 64, 16, 32, None, True),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=_name)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c[:7])))
def test_plain_vs_jax_kernel(case, dtype):
    kind, b, hq, hkv, s, d, block, lead, with_seg = case
    (qn, kn, vn), (q, k, v) = _inputs(b, hq, hkv, s, d, dtype, seed=s + d)
    bias = None if lead is None else np.random.default_rng(3).standard_normal(
        lead + (s, s)).astype(np.float32)
    seg = _segments(b, s) if with_seg else None
    got = TF.flash_attention(q, k, v, bias=None if bias is None else torch.from_numpy(bias),
                             segment_ids=None if seg is None else torch.from_numpy(seg),
                             kind=kind, block_q=block, block_kv=block, device="cpu")
    assert got.dtype == dtype
    want = RF.flash_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                              bias=None if bias is None else jnp.asarray(bias),
                              segment_ids=None if seg is None else jnp.asarray(seg),
                              kind=kind, block_q=block, block_kv=block, interpret=True)
    assert want.dtype == NP[dtype]
    within_one_ulp(got, torch.from_numpy(np.asarray(want).astype(np.float32)), dtype,
                   v.abs().max().item())


def test_16bit_activations_take_the_flash_route():
    """The tuner maps the reduced prefill's shape for 16-bit activations
    on the CPU and on the card's tables: no dtype sends it to chunked.
    The 16-bit route is ``flash16_wgmma`` at 64- and 128-row tiles and
    ``flash16`` (the GQA group's heads stacked on ``wgmma``) below them."""
    for dtype in (torch.float32,) + DTYPES:
        assert TT.choose_attn_impl(64, 4, 16, device="cpu", dtype=dtype).impl == "flash"
        assert all(TF.kernel_fits(bq, d, dtype) for bq in TF.KERNEL_BLOCKS
                   for d in TF.KERNEL_HEAD_DIMS)
    assert TF.KERNEL_BLOCKS == (8, 16, 32, 64, 128)
    for dt in DTYPES:
        assert [TF.flash_route(bq, dt) for bq in TF.KERNEL_BLOCKS] == (
            ["flash16"] * 3 + ["flash16_wgmma"] * 2)


def test_reduced_prefill_at_the_config_dtype_matches_jax():
    cfg = REDUCED["yi-6b"]()
    rcfg = R_REDUCED["yi-6b"]().replace(remat="none")
    assert cfg.act_dtype == rcfg.act_dtype == "bfloat16"
    assert cfg.param_dtype == rcfg.param_dtype == "float32"
    rmodel = RModel(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    model = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    logits, _ = model.prefill({"tokens": torch.from_numpy(tokens).long()})
    rlogits, _ = rmodel.prefill(params, {"tokens": jnp.asarray(tokens)})
    assert logits.dtype == torch.bfloat16
    got, want = logits.float().numpy(), np.asarray(rlogits).astype(np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-5 * np.abs(want).max())


# ---------------------------------------------------------------- the kernel's arithmetic


def two_part(p: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """``P V`` as the kernel takes it: ``lo V + hi V`` with P's two 16-bit
    parts; a product of two 16-bit values is exact in float32, so float32
    matrix products of the parts emulate the MMAs up to the order of the
    float32 sums."""
    hi = p.to(dtype).to(torch.float32)
    lo = (p - hi).to(dtype).to(torch.float32)
    vf = v.to(torch.float32)
    return lo @ vf + hi @ vf


def one_part(p: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """``P V`` with P rounded once to the 16-bit type."""
    return p.to(dtype).to(torch.float32) @ v.to(torch.float32)


def flash16_emulation(q, k, v, block_q, scale, bias=None, seg=None, kind="folded"):
    """The 16-bit recurrence: per query tile, KV sub-chunks of
    ``min(16, block_q)`` keys, ``S = (Q K^T) * scale`` from exact 16-bit
    products, bias and masks on the scores, the online max and sum,
    ``O = alpha O + two_part(P, V)``, the output rounded once."""
    dtype = q.dtype
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    nq, bc = s // block_q, min(16, block_q)
    out = torch.zeros_like(q)
    for bh in range(b * hq):
        bi, h = divmod(bh, hq)
        qf = q[bi, h].to(torch.float32)
        kk, vv = k[bi, h // g].to(torch.float32), v[bi, h // g]
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
                    sc = (qf[rq] @ kk[rk].T) * scale
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
                    acc = acc * alpha[:, None] + two_part(pr, vv[rk], dtype)
                    m = mn
                if last:
                    out[bi, h, rq] = (acc / torch.where(l == 0, 1.0, l)[:, None]).to(dtype)
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=_name)
@pytest.mark.parametrize(
    "block_q,with_bias,with_seg,kind",
    [(16, False, False, "folded"), (32, True, False, "folded"), (16, True, True, "bb"),
     (8, False, True, "folded")],
)
def test_flash16_recurrence_within_one_ulp_of_the_plain_version(block_q, with_bias, with_seg,
                                                                kind, dtype):
    b, hq, hkv, s, d = 2, 4, 2, 64, 32
    _, (q, k, v) = _inputs(b, hq, hkv, s, d, dtype, seed=block_q)
    rng = np.random.default_rng(block_q + 1)
    bias = (torch.from_numpy(rng.standard_normal((1, hq, s, s)).astype(np.float32))
            if with_bias else None)
    seg = torch.from_numpy(_segments(b, s)) if with_seg else None
    scale = d**-0.5
    got = flash16_emulation(q, k, v, block_q, scale, bias, seg, kind)
    want = TF.FLASH.plain(kind, block_q, scale, q, k, v, bias, seg)
    assert got.dtype == want.dtype == dtype
    within_one_ulp(got, want, dtype, v.abs().max().item())


def _tile(kind: str, dtype, n: int = 64, d: int = 64, seed: int = 0):
    """One tile's float32 probabilities P (rows of a softmax, masked
    entries 0), its denominators and a 16-bit V: random scores, scores
    with a bias, or causal and segment masks."""
    rng = np.random.default_rng(seed)
    sc = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)) * 2.0
    ok = torch.ones((n, n), dtype=torch.bool)
    if kind == "bias":
        sc = sc + torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)) * 4.0
    elif kind == "masked":
        seg = torch.from_numpy((np.arange(n) >= n // 3).astype(np.int32))
        ok = torch.ones((n, n), dtype=torch.bool).tril() & (seg[:, None] == seg[None, :])
    sc = torch.where(ok, sc, TF.NEG_INF)
    p = torch.where(ok, torch.exp(sc - sc.amax(1, keepdim=True)), 0.0)
    v = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
    return p, p.sum(1, keepdim=True), v


@pytest.mark.parametrize("dtype", DTYPES, ids=_name)
@pytest.mark.parametrize("kind", ["random", "bias", "masked"])
def test_two_part_p_matches_float32_p(kind, dtype, capsys):
    """O from the two-part P rounds to O from float32 P within the gate;
    its float32 value lies within float32 P's own error of the float64
    truth plus the split's (2p + 2 bits of P).  A single 16-bit rounding of P strays further, reported
    beside it (in ulps of the rounded output) and asserted only as
    measured: farther from the truth than the two-part P."""
    p, l, v = _tile(kind, dtype, seed={"random": 0, "bias": 1, "masked": 2}[kind])
    exact = (p.double() @ v.double()) / l.double()
    f32 = (p @ v.to(torch.float32)) / l
    two = two_part(p, v, dtype) / l
    one = one_part(p, v, dtype) / l
    worst_two = within_one_ulp(two.to(dtype), f32.to(dtype), dtype, v.abs().max().item())
    err_two = (two.double() - exact).abs().max().item()
    err_one = (one.double() - exact).abs().max().item()
    err_f32 = (f32.double() - exact).abs().max().item()
    tol = ulp(f32, dtype)
    one_ulps = ((one.to(dtype).to(torch.float32) - f32.to(dtype).to(torch.float32)).abs()
                / tol).max().item()
    with capsys.disabled():
        print(f"\n{_name(dtype)} {kind}: |O - exact| two-part {err_two:.2e}, one rounding "
              f"{err_one:.2e}, float32 P {err_f32:.2e}; rounded output off float32 P's by "
              f"{worst_two:.0f} ulp (two-part), {one_ulps:.0f} ulp (one rounding)")
    # P's split keeps 2p + 2 bits: the two-part error is float32 P's plus that.
    bits = 2 * FMT[dtype][0] + 2
    assert err_two <= err_f32 + 2.0**-bits * v.to(torch.float32).abs().max().item()
    assert err_one > err_two
