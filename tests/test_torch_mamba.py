"""Mamba and jamba-v0.1-52b in the port against the JAX package.

``mamba_apply`` alone: the train output, the prefill output with its
cache (the last SSM state and the conv tail) and the O(1) decode step
within ``1e-5 + 1e-5 * max|y|``.  The port scans in chunks
(``SCAN_CHUNK``) where the reference runs ``jax.lax.associative_scan``;
the test runs the default chunk and one of 7 tokens, whose last chunk is
ragged.  The float32 leaves (``dt_bias``, ``a_log``, ``d_skip``) stay
float32 under bfloat16 parameters, as the reference's do.  Then the
reduced jamba model (one period: Mamba at 7 of 8 layers, attention at
index 4, MoE on odd layers): prefill, decode, ``Model.loss`` with the
balance loss, every gradient, and one AdamW and one Adafactor update,
within the tolerances of ``tests/port_family.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_family as PF
import port_threads  # noqa: F401  (one torch thread a worker)
from repro.configs import jamba_v01_52b as RJ
from repro.models import mamba as RMB
from repro_torch.configs import jamba_v01_52b as TJ
from repro_torch.models import mamba as TMB

ARCH = "jamba-v0.1-52b"
# ArchConfig.param_count of FULL in the JAX package
FULL_PARAMS = 51_570_315_264


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DISABLE", "1")


def test_config_is_the_reference_field_for_field():
    PF.check_config(TJ, RJ, FULL_PARAMS)
    assert [s.mixer for s in TJ.FULL.period].count("attn") == 1
    assert TJ.FULL.period[4].mixer == "attn" and TJ.FULL.replace(n_layers=8).n_periods == 1


def test_float32_leaves_under_bfloat16_params():
    tcfg, rcfg = PF.cfgs(ARCH)
    ref = jax.eval_shape(lambda: RMB.mamba_init(jax.random.PRNGKey(0), rcfg, jnp.bfloat16))
    p = TMB.mamba_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    for name, leaf in ref.items():
        assert tuple(p[name].shape) == leaf.shape, name
        assert str(p[name].dtype)[6:] == str(leaf.dtype), name
    assert torch.equal(p["a_log"], torch.log(torch.arange(1.0, 17.0))[None].expand(128, 16))
    assert torch.equal(p["d_skip"], torch.ones(128)) and not p["conv_b"].any()
    step = torch.nn.functional.softplus(p["dt_bias"])
    assert float(step.min()) >= 0.001 - 1e-6 and float(step.max()) <= 0.1 + 1e-6


@pytest.fixture(scope="module")
def mamba_case():
    """(port config, JAX params, x, JAX train out, prefill out and cache,
    decode out and cache on the next token)."""
    PF.hermetic()
    tcfg, rcfg = PF.cfgs(ARCH)
    params = RMB.mamba_init(jax.random.PRNGKey(5), rcfg, jnp.float32)
    x = np.random.default_rng(8).standard_normal((2, 33, rcfg.d_model)).astype(np.float32)
    apply = jax.jit(RMB.mamba_apply, static_argnums=1, static_argnames="mode")
    train, _ = apply(params, rcfg, jnp.asarray(x[:, :32]), mode="train")
    out, cache = apply(params, rcfg, jnp.asarray(x[:, :32]), mode="prefill")
    dout, dcache = apply(params, rcfg, jnp.asarray(x[:, 32:]), cache=cache, mode="decode")
    return tcfg, params, x, np.asarray(train), np.asarray(out), cache, np.asarray(dout), dcache


@pytest.mark.parametrize("chunk", [TMB.SCAN_CHUNK, 7])
def test_mamba_scan_and_decode_match_jax(mamba_case, chunk, monkeypatch):
    tcfg, params, x, rtrain, rout, rcache, rdout, rdcache = mamba_case
    monkeypatch.setattr(TMB, "SCAN_CHUNK", chunk)
    p = PF.load_module(TMB.Mamba(tcfg, torch.float32, "cpu"), params)
    xs = torch.from_numpy(x)
    train, none = TMB.mamba_apply(p, tcfg, xs[:, :32], mode="train")
    PF.module_close(train, rtrain)
    assert none is None
    out, cache = TMB.mamba_apply(p, tcfg, xs[:, :32], mode="prefill")
    PF.module_close(out, rout)
    for got, want in zip(cache, rcache):
        PF.module_close(got, want)
    dout, dcache = TMB.mamba_apply(p, tcfg, xs[:, 32:], cache=cache, mode="decode")
    PF.module_close(dout, rdout)
    assert dcache[0].dtype == torch.float32
    for got, want in zip(dcache, rdcache):
        PF.module_close(got, want)


def test_init_mamba_cache_shapes():
    tcfg, rcfg = PF.cfgs(ARCH)
    mine = TMB.init_mamba_cache(tcfg, 3, torch.bfloat16, device="cpu")
    ref = RMB.init_mamba_cache(rcfg, 3, jnp.bfloat16)
    assert [tuple(t.shape) for t in mine] == [r.shape for r in ref]
    assert [str(t.dtype)[6:] for t in mine] == [str(r.dtype) for r in ref]


@pytest.fixture(scope="module")
def ref():
    return PF.reference(ARCH)


def test_reduced_prefill_and_decode_match_jax(ref):
    PF.check_served(ref)


def test_reduced_loss_and_grads_match_jax(ref):
    PF.check_loss_and_grads(ref)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(ref, kind):
    PF.check_optimizer_update(ref, kind)
