"""seamless-m4t-large-v2 in the port against the JAX package: the
bidirectional encoder and cross attention.

``full_attention`` alone with ``Hq != Hkv`` over three key chunks,
``attn_apply`` bidirectional (the encoder's, RoPE'd, with its prefill
cache) and with ``cross_kv`` (no RoPE, no cache, in every mode), and
``layernorm``, each within ``1e-5 + 1e-5 * max|y|``.  ``init_cache``
has the reference's layout, the encoder's K/V (``"cross"``) included.
Then the reduced seamless (2 encoder and 2 decoder layers) on 32 frame
embeddings: prefill (logits, each block's self-attention and cross
caches), two greedy decode steps that read the cross caches, and
``Model.loss`` and every gradient (the encoder's included), within the
tolerances of ``tests/port_family.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_family as PF
import port_threads  # noqa: F401  (one torch thread a worker)
from repro.configs import seamless_m4t_large_v2 as RSM
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models.model import Model as RModel
from repro_torch.configs import seamless_m4t_large_v2 as TSM
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.model import Model

ARCH = "seamless-m4t-large-v2"
# ArchConfig.param_count of FULL in the JAX package
FULL_PARAMS = 2_034_784_256


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DISABLE", "1")


def test_config_is_the_reference_field_for_field():
    PF.check_config(TSM, RSM, FULL_PARAMS)
    assert TSM.FULL.encoder_layers == TSM.FULL.n_layers == 24 and TSM.FULL.hd == 64


@pytest.mark.parametrize("hq,hkv", [(4, 2), (6, 2), (4, 4)])
def test_full_attention_matches_jax(hq, hkv):
    rng = np.random.default_rng(hq + hkv)
    q = rng.standard_normal((2, hq, 10, 16)).astype(np.float32)
    k = rng.standard_normal((2, hkv, 24, 16)).astype(np.float32)
    v = rng.standard_normal((2, hkv, 24, 16)).astype(np.float32)
    got = TA.full_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            chunk=8)
    want = RA.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=8)
    PF.module_close(got, want)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(5)
    x = (3 + 2 * rng.standard_normal((2, 5, 16))).astype(np.float32)
    w, b = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    got = TL.layernorm({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                       torch.from_numpy(x), 1e-5)
    want = RL.layernorm({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), 1e-5)
    PF.module_close(got, want)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_attn_apply_bidirectional_and_cross_match_jax(mode):
    tcfg, rcfg = PF.cfgs(ARCH)
    p = TA.attn_init(torch.Generator().manual_seed(4), tcfg)
    params = {k: jnp.asarray(v.numpy()) for k, v in p.state_dict().items()}
    rng = np.random.default_rng(6)
    s = 1 if mode == "decode" else 9
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s) + 3, (2, s)).astype(np.int32)
    kv = tuple(rng.standard_normal((2, tcfg.n_kv_heads, 7, tcfg.hd)).astype(np.float32)
               for _ in range(2))
    out, cache = TA.attn_apply(p, tcfg, torch.from_numpy(x), torch.from_numpy(pos), mode=mode,
                               cross_kv=tuple(torch.from_numpy(t) for t in kv))
    rout, _ = RA.attn_apply(params, rcfg, jnp.asarray(x), jnp.asarray(pos), mode=mode,
                            cross_kv=tuple(jnp.asarray(t) for t in kv))
    PF.module_close(out, rout)
    assert cache is None
    if mode == "decode":
        return
    out, cache = TA.attn_apply(p, tcfg, torch.from_numpy(x), torch.from_numpy(pos), mode=mode,
                               bidirectional=True)
    rout, rcache = RA.attn_apply(params, rcfg, jnp.asarray(x), jnp.asarray(pos), mode=mode,
                                 bidirectional=True)
    PF.module_close(out, rout)
    assert (cache is None) == (rcache is None) == (mode == "train")
    for got, want in zip(cache or (), rcache or ()):
        PF.module_close(got, want)


def test_init_cache_has_the_reference_layout():
    tcfg, rcfg = PF.cfgs(ARCH)
    mine = Model(tcfg, device="cpu").init_cache(3, 10, torch.bfloat16)
    ref = RModel(rcfg).init_cache(3, 10, jnp.bfloat16)
    assert len(mine["stack"]) == tcfg.n_periods
    for name, block in ref["stack"].items():
        assert sorted(mine["stack"][0][name]) == sorted(block) == ["cross", "mixer"]
        for part in block:
            for got, want in zip(mine["stack"][1][name][part], block[part]):
                assert (tcfg.n_periods,) + tuple(got.shape) == want.shape
                assert got.dtype == torch.bfloat16 and not got.any()


@pytest.fixture(scope="module")
def ref():
    return PF.reference(ARCH)


def test_reduced_prefill_and_decode_match_jax(ref):
    assert ref["extra"]["src_embeds"].shape == (PF.B, PF.S, 64)
    assert sorted(ref["caches"]["stack"]["l0"]) == ["cross", "mixer"]
    PF.check_served(ref)


def test_reduced_loss_and_grads_match_jax(ref):
    assert any(name.startswith("encoder.stack.") for name in ref["grads"])
    PF.check_loss_and_grads(ref)


def test_decode_reads_the_cross_cache(ref):
    """A decode step carries each block's cross cache unchanged, and its
    logits follow it: zeroed encoder K/V give other logits."""
    model = PF.port_model(ref)
    tokens = torch.from_numpy(ref["tokens"][:, :PF.S]).long()
    _, caches = model.prefill({"tokens": tokens, **PF.torch_extra(ref)})
    tok, pos, _ = ref["steps"][0]
    step = {"tokens": torch.from_numpy(tok).long(), "pos": torch.from_numpy(pos).long()}
    logits, new = model.decode(caches, step)
    for k in range(model.cfg.n_periods):
        assert new["stack"][k]["l0"]["cross"] is caches["stack"][k]["l0"]["cross"]
    blank = [{"l0": {"mixer": c["l0"]["mixer"],
                     "cross": tuple(torch.zeros_like(t) for t in c["l0"]["cross"])}}
             for c in caches["stack"]]
    other, _ = model.decode({"stack": blank}, step)
    assert not torch.allclose(logits, other, rtol=1e-2, atol=1e-2)
