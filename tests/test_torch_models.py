"""The port's model layers and attention against the JAX package's, on
the same numpy inputs and parameters.

Elementwise layers (RMSNorm, RoPE, embedding) agree within 1e-6; layers
with matrix products and softmax sums within atol = rtol = 1e-5, since
float32 sums run in another order in the two frameworks.
"""

import dataclasses
import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.configs import yi_6b as RY
from repro.configs.ALL import REDUCED as R_REDUCED
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import transformer as RTR
from repro_torch.autotune import tuner as TT
from repro_torch.configs import ALL as TALL
from repro_torch.configs import base as TB
from repro_torch.configs import yi_6b as TY
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ref as TR
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTR
from repro_torch.models.convert import flatten_tree

TOL = dict(atol=1e-5, rtol=1e-5)
RNG = np.random.default_rng(5)


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


def _f32(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _cfgs():
    port = TALL.REDUCED["yi-6b"]().replace(act_dtype="float32", param_dtype="float32")
    ref = R_REDUCED["yi-6b"]().replace(act_dtype="float32", param_dtype="float32")
    return port, ref


# ---------------------------------------------------------------- configs


def test_yi_6b_config_is_the_reference_letter_for_letter():
    for mine, ref in ((TY.FULL, RY.FULL), (TY.reduced(), RY.reduced())):
        for f in dataclasses.fields(TB.ArchConfig):
            if f.name == "period":
                assert [(s.mixer, s.ffn) for s in mine.period] == \
                       [(s.mixer, s.ffn) for s in ref.period]
            else:
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.hd == ref.hd and mine.n_periods == ref.n_periods


def test_param_count_matches_jax():
    assert TY.reduced().param_count() == RY.reduced().param_count()
    assert TY.FULL.param_count() == 6_061_035_520


def test_other_architectures_are_not_ported():
    """Every architecture of the JAX package is ported now: ``config``
    returns each in full and reduced form and raises ``ValueError`` only
    for a name that is no architecture of the repository."""
    from repro.configs.base import REGISTRY, get_config

    assert TALL.config("yi-6b") is TY.FULL
    get_config("yi-6b")  # registers every architecture of the JAX package
    assert sorted(TALL.ARCH_IDS) == sorted(REGISTRY) and len(REGISTRY) == 10
    for name in TALL.ARCH_IDS:
        assert TALL.config(name).name == name
        assert TALL.config(name, smoke=True).name == f"{name}-smoke"
    with pytest.raises(ValueError, match="unknown"):
        TALL.config("gpt-2")


# ----------------------------------------------------------------- layers


def test_rmsnorm_matches_jax():
    x, w = _f32(2, 5, 16), _f32(16)
    got = TL.rmsnorm({"w": torch.from_numpy(w)}, torch.from_numpy(x), 1e-5)
    want = RL.rmsnorm({"w": jnp.asarray(w)}, jnp.asarray(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    x = _f32(2, 3, 7, 16)
    pos = RNG.integers(0, 4096, (2, 7)).astype(np.int32)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_swiglu_matches_jax():
    x = _f32(2, 5, 16)
    p = {"w1": _f32(16, 32), "w3": _f32(16, 32), "w2": _f32(32, 16)}
    got = TL.swiglu({k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x))
    want = RL.swiglu({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_matches_jax():
    e = _f32(50, 8)
    tok = RNG.integers(0, 50, (3, 6))
    got = TL.embed({"e": torch.from_numpy(e)}, torch.from_numpy(tok), torch.float32)
    want = RL.embed({"e": jnp.asarray(e)}, jnp.asarray(tok), jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_init_is_a_fan_in_truncated_normal():
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init((256, 64), g)
    assert w.shape == (256, 64) and float(w.abs().max()) <= 2 * 256**-0.5
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(w, TL.dense_init((256, 64), g2))
    e = TL.dense_init((10, 4), torch.Generator().manual_seed(1), scale=1.0)
    assert float(e.abs().max()) <= 2.0


# ------------------------------------------------------------- attention


@pytest.mark.parametrize("s,chunk,hq,hkv", [(64, 16, 4, 1), (48, 16, 4, 4), (96, 32, 8, 2),
                                            (32, 32, 2, 1)])
@pytest.mark.parametrize("schedule", ["folded", "bb"])
def test_chunked_attention_matches_jax(s, chunk, hq, hkv, schedule):
    """Even nq (the fold runs), odd nq and nq == 1 (both run bb)."""
    q, k, v = _f32(2, hq, s, 16), _f32(2, hkv, s, 16), _f32(2, hkv, s, 16)
    got = TA.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)), chunk=chunk,
                                      schedule=schedule)
    want = RA.chunked_causal_attention(*map(jnp.asarray, (q, k, v)), chunk=chunk,
                                       schedule=schedule)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_matches_jax():
    q, kc, vc = _f32(2, 4, 1, 16), _f32(2, 1, 24, 16), _f32(2, 1, 24, 16)
    kn, vn = _f32(2, 1, 1, 16), _f32(2, 1, 1, 16)
    args = (q, kc, vc, kn, vn)
    got = TA.decode_attention(*map(torch.from_numpy, args))
    want = RA.decode_attention(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["auto", "chunked", "flash-bb"])
def test_simplex_attention_matches_jax(impl):
    q, k, v = _f32(2, 4, 64, 16), _f32(2, 1, 64, 16), _f32(2, 1, 64, 16)
    got = TA.simplex_attention(*map(torch.from_numpy, (q, k, v)), impl=impl, chunk=32)
    want = RA.simplex_attention(*map(jnp.asarray, (q, k, v)), impl=impl, chunk=32,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_simplex_attention_guards():
    q, k = torch.zeros(1, 2, 32, 16), torch.zeros(1, 1, 32, 16)
    with pytest.raises(ValueError, match="impl"):
        TA.simplex_attention(q, k, k, impl="fast")
    # v_head_dim != qk head dim (MLA) takes the chunked path: no flash error
    out = TA.simplex_attention(q, k, torch.zeros(1, 1, 32, 8), impl="flash")
    assert out.shape == (1, 2, 32, 8)
    # the decoder's attention follows the config's executor knobs
    q, k = torch.randn(1, 2, 64, 16), torch.randn(1, 1, 64, 16)
    cfg = _cfgs()[0].replace(attention_impl="chunked", attention_schedule="bb")
    assert torch.equal(TA.sharded_causal_attention(q, k, k, cfg),
                       TA.chunked_causal_attention(q, k, k, chunk=32, schedule="bb"))


def _attn_params():
    port_cfg, _ = _cfgs()
    d, hq, hkv, hd = port_cfg.d_model, port_cfg.n_heads, port_cfg.n_kv_heads, port_cfg.hd
    scale = d**-0.5
    return {"wq": _f32(d, hq * hd) * scale, "wk": _f32(d, hkv * hd) * scale,
            "wv": _f32(d, hkv * hd) * scale, "wo": _f32(hq * hd, d) * scale}


def test_attn_apply_prefill_and_decode_match_jax():
    port_cfg, ref_cfg = _cfgs()
    p = _attn_params()
    tp = TA.Attention(port_cfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, a in p.items():
            tp[name].copy_(torch.from_numpy(a))
    jp = {name: jnp.asarray(a) for name, a in p.items()}
    b, s = 2, 64
    x = _f32(b, s, port_cfg.d_model)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    out, cache = TA.attn_apply(tp, port_cfg, torch.from_numpy(x), torch.from_numpy(pos),
                               mode="prefill")
    jout, jcache = RA.attn_apply(jp, ref_cfg, jnp.asarray(x), jnp.asarray(pos),
                                 mode="prefill")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for mine, ref in zip(cache, jcache):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **TOL)

    xd = _f32(b, 1, port_cfg.d_model)
    pd = np.full((b, 1), s, np.int32)
    dout, dcache = TA.attn_apply(tp, port_cfg, torch.from_numpy(xd), torch.from_numpy(pd),
                                 cache=cache, mode="decode")
    jdout, jdcache = RA.attn_apply(jp, ref_cfg, jnp.asarray(xd), jnp.asarray(pd),
                                   cache=jcache, mode="decode")
    np.testing.assert_allclose(dout.numpy(), np.asarray(jdout), **TOL)
    assert len(dcache) == len(jdcache) == 4
    for mine, ref in zip(dcache, jdcache):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **TOL)


def test_block_and_attn_init_mirror_the_jax_trees():
    """Parameter names and shapes of one block (and its attention) equal
    the JAX ``block_init`` tree's."""
    import jax

    port_cfg, ref_cfg = _cfgs()
    spec = port_cfg.period[0]
    g = torch.Generator().manual_seed(0)
    blk = TTR.block_init(g, port_cfg, spec)
    ref = RTR.block_init(jax.random.PRNGKey(0), ref_cfg, ref_cfg.period[0], jnp.float32)
    want = {k: v.shape for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, ref)).items()}
    assert {k: tuple(v.shape) for k, v in blk.state_dict().items()} == want
    assert torch.equal(blk["norm1"]["w"], torch.ones(port_cfg.d_model))
    att = TA.attn_init(torch.Generator().manual_seed(1), port_cfg)
    assert {f"mixer.{k}": tuple(v.shape) for k, v in att.state_dict().items()} == \
        {k: v for k, v in want.items() if k.startswith("mixer.")}
    with pytest.raises(ValueError, match="unknown block"):
        TTR.Block(port_cfg, type(spec)("rnn", "dense"), torch.float32, "cpu")


def test_init_kv_cache_shape():
    port_cfg, ref_cfg = _cfgs()
    kc, vc = TA.init_kv_cache(port_cfg, 3, 10, torch.float32, device="cpu")
    rk, _ = RA.init_kv_cache(ref_cfg, 3, 10, jnp.float32)
    assert kc.shape == vc.shape == rk.shape and not kc.any()


@pytest.mark.parametrize("mod", [TB, TALL, TL, TF, TR, TT], ids=lambda m: m.__name__)
def test_port_model_doctests(mod):
    result = doctest.testmod(mod, verbose=False)
    assert result.failed == 0 and result.attempted > 0
