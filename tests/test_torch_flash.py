"""The port's flash attention on the CPU (the kernel's plain PyTorch
version) against the JAX package's Pallas kernel in interpret mode and
its dense references, on the same numpy inputs.

Outputs agree within atol = rtol = 1e-5: both sides accumulate in
float32, but the matrix products and sums run in another order in the
two frameworks (the reference's own flash and chunked executors differ
by up to 4.77e-7).  The schedule arithmetic is compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.autotune import tuner as RT
from repro.kernels import flash_attention as RF
from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro_torch.autotune import tuner as TT
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    """No tuner cache is read or written by the JAX calls."""
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


def _qkv(b, hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


def _port(q, k, v, **kw):
    return TF.flash_attention(q, k, v, device="cpu", **kw).numpy()


def _jax(q, k, v, **kw):
    return np.asarray(RF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         interpret=True, **kw))


# (kind, b, hq, hkv, s, d, block): even and odd nq, GQA groups 1 and 4,
# D 16 and 64, and one tile (nq == 1 runs bb).
CASES = [
    ("folded", 2, 4, 1, 64, 16, 16),
    ("bb", 2, 4, 1, 64, 16, 16),
    ("folded", 1, 4, 4, 80, 64, 16),
    ("bb", 1, 4, 4, 80, 64, 16),
    ("folded", 1, 8, 2, 48, 64, 16),
    ("folded", 2, 4, 4, 32, 16, 32),
]


@pytest.mark.parametrize("kind,b,hq,hkv,s,d,block", CASES)
def test_flash_matches_jax_kernel_and_reference(kind, b, hq, hkv, s, d, block):
    q, k, v = _qkv(b, hq, hkv, s, d)
    kw = dict(kind=kind, block_q=block, block_kv=block)
    got = _port(q, k, v, **kw)
    np.testing.assert_allclose(got, _jax(q, k, v, **kw), **TOL)
    ref = np.asarray(RR.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got, ref, **TOL)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(got, TR.causal_attention(tq, tk, tv).numpy(), **TOL)


def _segments(b, s):
    """Packing ids whose later segments start inside a tile, so rows of
    the second segment see a fully masked first KV tile."""
    seg = np.zeros((b, s), np.int32)
    seg[0, 20:] = 1
    seg[-1, 40:] = 2
    return seg


@pytest.mark.parametrize("kind", ["folded", "bb"])
@pytest.mark.parametrize("bias_lead,with_seg", [((1, 4), False), ((2, 1), True),
                                                (None, True)])
def test_flash_bias_and_segments(kind, bias_lead, with_seg):
    b, hq, hkv, s, d = 2, 4, 2, 64, 16
    q, k, v = _qkv(b, hq, hkv, s, d, seed=1)
    rng = np.random.default_rng(2)
    bias = (None if bias_lead is None
            else rng.standard_normal(bias_lead + (s, s)).astype(np.float32))
    seg = _segments(b, s) if with_seg else None
    kw = dict(kind=kind, block_q=16, block_kv=16, bias=bias, segment_ids=seg)
    got = _port(q, k, v, **kw)
    jkw = dict(kw, bias=None if bias is None else jnp.asarray(bias),
               segment_ids=None if seg is None else jnp.asarray(seg))
    np.testing.assert_allclose(got, _jax(q, k, v, **jkw), **TOL)
    want = RF._reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jkw["bias"], jkw["segment_ids"], d**-0.5)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    tb = None if bias is None else torch.from_numpy(bias)
    ts = None if seg is None else torch.from_numpy(seg)
    mine = TF._reference_attention(*map(torch.from_numpy, (q, k, v)), tb, ts, d**-0.5)
    np.testing.assert_allclose(got, mine.numpy(), **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("nq", range(1, 34))
def test_grid_steps_and_pairs_equal_jax(nq):
    assert TF.flash_fold_pairs(nq) == RF.flash_fold_pairs(nq)
    for kind in ("folded", "bb"):
        assert TF.flash_grid_steps(nq, kind) == RF.flash_grid_steps(nq, kind)
    for p in range(TF.flash_fold_pairs(nq)):
        for j in range(nq + 1):
            want = tuple(int(x) for x in RF._folded_qkv(p, j, nq))
            assert tuple(int(x) for x in TF.folded_qkv(p, j, nq)) == want


def test_grid_steps_errors():
    for bad in ((0, "bb"), (4, "diag")):
        with pytest.raises(ValueError):
            TF.flash_grid_steps(*bad)
        with pytest.raises(ValueError):
            RF.flash_grid_steps(*bad)


# (what, shapes (b, hq, hkv, s, d), kwargs, message)
BAD = [
    ("s not divisible", (1, 2, 1, 60, 16), dict(block_q=16, block_kv=16), "divisible"),
    ("non-square tiles", (1, 2, 1, 64, 16), dict(block_q=16, block_kv=32), "square"),
    ("unknown kind", (1, 2, 1, 64, 16), dict(kind="diag", block_q=16, block_kv=16),
     "unknown"),
    ("3-D bias", (1, 2, 1, 32, 16), dict(block_q=16, block_kv=16, bias=(2, 32, 32)), "4-D"),
    ("bias trailing", (1, 2, 1, 32, 16), dict(block_q=16, block_kv=16,
                                              bias=(1, 2, 32, 16)), "trailing"),
    ("bias lead", (2, 2, 1, 32, 16), dict(block_q=16, block_kv=16, bias=(3, 1, 32, 32)),
     "broadcast"),
    ("segment shape", (2, 2, 1, 32, 16), dict(block_q=16, block_kv=16, segment_ids=(2, 16)),
     "segment_ids"),
]


@pytest.mark.parametrize("what,shape,kw,msg", BAD, ids=[c[0] for c in BAD])
def test_flash_value_errors_match_jax(what, shape, kw, msg):
    q, k, v = _qkv(*shape[:3], *shape[3:])
    for key in ("bias", "segment_ids"):
        if key in kw:
            kw = dict(kw, **{key: np.zeros(kw[key], np.float32 if key == "bias" else np.int32)})
    with pytest.raises(ValueError, match=msg):
        _port(q, k, v, **kw)
    jkw = {key: jnp.asarray(val) if isinstance(val, np.ndarray) else val
           for key, val in kw.items()}
    with pytest.raises(ValueError):
        _jax(q, k, v, **jkw)


@pytest.mark.parametrize("s", [64, 60])
def test_causal_flash_attention_auto_matches_jax(s):
    """kind='auto': the folded kernel at s=64, the dense reference route
    at s=60 where no tile divides the sequence."""
    q, k, v = _qkv(2, 4, 1, s, 16, seed=3)
    got = TO.causal_flash_attention(q, k, v, device="cpu").numpy()
    want = np.asarray(RO.causal_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seq", [8, 16, 24, 32, 48, 60, 64, 96, 128, 256, 2048])
def test_attn_block_q_cpu_rule_matches_jax(seq):
    assert TT.attn_block_q(seq, 16, device="cpu") == RT.attn_block_q(seq, 16, backend="cpu")


def test_choose_attn_impl_matches_jax_at_reduced_serve_shape():
    """Reduced yi-6b serving: seq 64, 4 heads, head_dim 16."""
    mine = TT.choose_attn_impl(64, 4, 16, device="cpu")
    ref = RT.choose_attn_impl(64, 4, 16, backend="cpu")
    assert (mine.impl, mine.kind, mine.block_q) == (ref.impl, ref.kind, ref.block_q)
    none = TT.choose_attn_impl(60, 4, 16, device="cpu")
    assert (none.impl, none.block_q) == ("chunked", 0)
    assert RT.choose_attn_impl(60, 4, 16, backend="cpu").impl == "chunked"


def test_card_tile_rule():
    """On the card the largest tile the kernel is built for that fits its
    shared memory (the rule is arithmetic; nothing is launched)."""
    assert TT.attn_block_q(2048, 128, device="cuda") == 128
    assert TT.attn_block_q(1920, 128, device="cuda") == 128
    assert TT.attn_block_q(96, 128, device="cuda") == 32
    assert TT.attn_block_q(64, 256, device="cuda") == 0  # no kernel for D=256
    assert TT.choose_attn_impl(64, 4, 256, device="cuda").impl == "chunked"
    assert TF.flash_smem_bytes(128, 128) <= TF.SMEM_LIMIT


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    q, k, v = _qkv(1, 2, 1, 32, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TO.causal_flash_attention(q, k, v)


def test_cpu_calls_leave_the_launch_counter():
    before = TF.launch_counts()["flash"]
    q, k, v = _qkv(1, 2, 1, 32, 16)
    _port(q, k, v, block_q=16, block_kv=16)
    TO.causal_flash_attention(q, k, v, device="cpu")
    assert TF.launch_counts()["flash"] == before
