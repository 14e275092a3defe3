"""The dense family in the port: granite-8b, internlm2-20b and
stablelm-12b beside yi-6b, against the JAX package's configs and models.

Each config is the reference's field for field, in full and reduced, and
counts the reference's parameters.  The reduced models serve as the
reference's do: the port's prefill and greedy decode on the parameters
of the JAX ``Model`` (``params_from_jax``) agree with JAX's logits within
yi-6b's tolerance, ``rtol 2e-3, atol 2e-4`` (``test_torch_serve.py``).
internlm2-20b's reduced GQA group is 3 (6 / 2 heads); stablelm-12b's
full head dim, 160, is no flash tile's, so on the card its prefill takes
the chunked executor, as the reference's does on a compiled TPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)
from repro.configs import granite_8b as RG
from repro.configs import internlm2_20b as RI
from repro.configs import stablelm_12b as RS
from repro.models.model import Model as RModel
from repro_torch.autotune import tuner as TT
from repro_torch.configs import ALL as TALL
from repro_torch.configs import base as TB
from repro_torch.configs import granite_8b as TG
from repro_torch.configs import internlm2_20b as TI
from repro_torch.configs import stablelm_12b as TS
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-3, atol=2e-4)
B, S, STEPS = 2, 32, 2
PAIRS = {"granite-8b": (TG, RG), "internlm2-20b": (TI, RI), "stablelm-12b": (TS, RS)}
# ArchConfig.param_count of each FULL config in the JAX package
FULL_PARAMS = {"granite-8b": 8_254_689_280, "internlm2-20b": 19_861_149_696,
               "stablelm-12b": 12_142_924_800}


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DISABLE", "1")


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_config_is_the_reference_field_for_field(arch):
    mine_mod, ref_mod = PAIRS[arch]
    assert TALL.config(arch) is mine_mod.FULL
    for mine, ref in ((mine_mod.FULL, ref_mod.FULL), (mine_mod.reduced(), ref_mod.reduced())):
        for f in dataclasses.fields(TB.ArchConfig):
            if f.name == "period":
                assert [(s.mixer, s.ffn) for s in mine.period] == \
                       [(s.mixer, s.ffn) for s in ref.period]
            else:
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.hd == ref.hd and mine.n_periods == ref.n_periods


@pytest.mark.parametrize("arch", sorted(PAIRS))
def test_param_count_matches_jax(arch):
    mine_mod, ref_mod = PAIRS[arch]
    assert mine_mod.reduced().param_count() == ref_mod.reduced().param_count()
    assert mine_mod.FULL.param_count() == ref_mod.FULL.param_count() == FULL_PARAMS[arch]


def test_full_shapes_on_the_card():
    """Which flash tile each full config's prefill (4 x 2048 tokens) takes
    on the card: a 128-row tile for granite-8b (group 4) and
    internlm2-20b (group 6), none for stablelm-12b (head dim 160)."""
    assert (TG.FULL.hd, TG.FULL.n_heads // TG.FULL.n_kv_heads) == (128, 4)
    assert (TI.FULL.hd, TI.FULL.n_heads // TI.FULL.n_kv_heads) == (128, 6)
    assert TS.FULL.hd == 160
    for cfg, want in ((TG.FULL, 128), (TI.FULL, 128), (TS.FULL, 0)):
        assert TT.attn_block_q(2048, cfg.hd, device="cuda") == want  # no card is asked
    assert TI.reduced().n_heads // TI.reduced().n_kv_heads == 3


@pytest.fixture(scope="module", params=sorted(PAIRS))
def served(request):
    """(arch, numpy params, tokens, JAX prefill logits, JAX decode logits
    of each step on JAX's greedy tokens), the JAX side once per arch."""
    import os

    os.environ["REPRO_AUTOTUNE_DISABLE"] = "1"
    arch = request.param
    rcfg = PAIRS[arch][1].reduced().replace(act_dtype="float32", param_dtype="float32",
                                            remat="none")
    rmodel = RModel(rcfg)
    params = jax.jit(rmodel.init)(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(7).integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    rlogits, rcaches = jax.jit(rmodel.prefill)(params, {"tokens": jnp.asarray(tokens)})
    decode = jax.jit(rmodel.decode)
    tok = np.asarray(jnp.argmax(rlogits[:, -1], -1))[:, None].astype(np.int32)
    steps = []
    for i in range(STEPS):
        pos = np.full((B,), S + i, np.int32)
        rlg, _ = decode(params, rcaches, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos)})
        steps.append((tok, pos, np.asarray(rlg)))
        tok = np.asarray(rlg)[:, -1].argmax(-1)[:, None].astype(np.int32)
    return (arch, jax.tree_util.tree_map(np.asarray, params), tokens, np.asarray(rlogits),
            jax.tree_util.tree_map(np.asarray, rcaches), steps)


def test_reduced_prefill_and_decode_match_jax(served):
    arch, np_params, tokens, rlogits, rcaches, steps = served
    cfg = TALL.config(arch, smoke=True).replace(act_dtype="float32", param_dtype="float32")
    model = params_from_jax(cfg, np_params, device="cpu")
    logits, caches = model.prefill({"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(logits.numpy(), rlogits, **TOL)
    for k in range(cfg.n_periods):
        for mine, ref in zip(caches["stack"][k]["l0"]["mixer"], rcaches["stack"]["l0"]["mixer"]):
            np.testing.assert_allclose(mine.numpy(), ref[k], **TOL)
    for tok, pos, rlg in steps:
        lg, _ = model.decode(caches, {"tokens": torch.from_numpy(tok).long(),
                                      "pos": torch.from_numpy(pos).long()})
        np.testing.assert_allclose(lg.numpy(), rlg, **TOL)
