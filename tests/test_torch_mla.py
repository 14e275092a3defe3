"""MLA and deepseek-v3-671b in the port against the JAX package.

``mla_apply`` alone, in its expanded form (prefill: output and the latent
cache) and its absorbed decode over that cache, within ``1e-5 + 1e-5 *
max|y|``; the expanded attention takes the chunked executor (qk head dim
24 against v head dim 16), as the reference's dispatch sends it.  Then
the reduced deepseek-v3 model (one dense prefix layer, two MoE layers, the
MTP head): prefill, decode, ``Model.loss`` with the balance loss and
``0.3 *`` the MTP cross-entropy, and every gradient, within the
tolerances of ``tests/port_family.py``; the optimizers' stacked-leaf
rules leave the prefix and MTP leaves as they are, and one AdamW and one
Adafactor update match the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_family as PF
import port_threads  # noqa: F401  (one torch thread a worker)
from repro.configs import deepseek_v3_671b as RD
from repro.models import mla as RML
from repro_torch.configs import deepseek_v3_671b as TD
from repro_torch.models import attention as TA
from repro_torch.models import mla as TML
from repro_torch.models import model as TMO
from repro_torch.optim import optimizer as TO

ARCH = "deepseek-v3-671b"
# ArchConfig.param_count of FULL in the JAX package
FULL_PARAMS = 671_712_655_360


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DISABLE", "1")


def test_config_is_the_reference_field_for_field():
    PF.check_config(TD, RD, FULL_PARAMS)
    cut = TD.FULL.replace(n_layers=4)
    assert (cut.n_prefix, cut.n_periods) == (3, 1)
    with pytest.raises(ValueError, match="prefix"):
        TD.FULL.replace(n_layers=2).n_periods


@pytest.fixture(scope="module")
def mla_case():
    """(configs, JAX params, x, JAX prefill out and cache, JAX decode out
    and cache on the next token)."""
    PF.hermetic()
    tcfg, rcfg = PF.cfgs(ARCH)
    params = RML.mla_init(jax.random.PRNGKey(4), rcfg, jnp.float32)
    rng = np.random.default_rng(6)
    b, s = 2, 32
    x = rng.standard_normal((b, s + 1, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s + 1)[None], (b, s + 1)).astype(np.int32)
    apply = jax.jit(RML.mla_apply, static_argnums=1, static_argnames="mode")
    out, cache = apply(params, rcfg, jnp.asarray(x[:, :s]), jnp.asarray(pos[:, :s]),
                       mode="prefill")
    dout, dcache = apply(params, rcfg, jnp.asarray(x[:, s:]), jnp.asarray(pos[:, s:]),
                         cache=cache, mode="decode")
    return tcfg, params, x, pos, np.asarray(out), cache, np.asarray(dout), dcache


def test_mla_prefill_matches_jax(mla_case, monkeypatch):
    tcfg, params, x, pos, rout, rcache, _, _ = mla_case
    p = PF.load_module(TML.MLA(tcfg, torch.float32, "cpu"), params)
    monkeypatch.setattr(TA, "flash_attention", lambda *a, **k: pytest.fail("flash called"))
    s = rout.shape[1]
    out, cache = TML.mla_apply(p, tcfg, torch.from_numpy(x[:, :s]),
                               torch.from_numpy(pos[:, :s]).long(), mode="prefill")
    PF.module_close(out, rout)
    assert len(cache) == 2
    for got, want in zip(cache, rcache):
        PF.module_close(got, want)
    _, none = TML.mla_apply(p, tcfg, torch.from_numpy(x[:, :s]),
                            torch.from_numpy(pos[:, :s]).long(), mode="train")
    assert none is None


def test_mla_absorbed_decode_matches_jax(mla_case):
    tcfg, params, x, pos, rout, rcache, rdout, rdcache = mla_case
    p = PF.load_module(TML.MLA(tcfg, torch.float32, "cpu"), params)
    s = rout.shape[1]
    cache = tuple(torch.from_numpy(np.array(c)) for c in rcache)
    out, new = TML.mla_apply(p, tcfg, torch.from_numpy(x[:, s:]),
                             torch.from_numpy(pos[:, s:]).long(), cache=cache, mode="decode")
    PF.module_close(out, rdout)
    assert len(new) == len(rdcache) == 4
    for got, want in zip(new, rdcache):
        PF.module_close(got, want)


def test_init_mla_cache_is_the_latent_pair():
    tcfg, rcfg = PF.cfgs(ARCH)
    mine = TML.init_mla_cache(tcfg, 3, 10, torch.float32, device="cpu")
    ref = RML.init_mla_cache(rcfg, 3, 10, jnp.float32)
    assert [tuple(t.shape) for t in mine] == [r.shape for r in ref]
    assert not any(t.any() for t in mine)


@pytest.fixture(scope="module")
def ref():
    return PF.reference(ARCH)


def test_reduced_prefill_and_decode_match_jax(ref):
    PF.check_served(ref)


def test_reduced_loss_with_mtp_and_grads_match_jax(ref):
    PF.check_loss_and_grads(ref)
    model = PF.port_model(ref)
    tokens = torch.from_numpy(ref["tokens"]).long()
    total, m = model.loss({"tokens": tokens})
    model.cfg = model.cfg.replace(mtp=False)
    plain, _ = model.loss({"tokens": tokens})
    assert abs(plain.item() - (ref["ce"] + ref["aux"])) <= PF.LOSS_REL * ref["loss"]
    assert (total - plain).item() > 0 and TMO.MTP_WEIGHT == 0.3


def test_prefix_and_mtp_leaves_stay_unstacked(ref):
    model = PF.port_model(ref)
    names = [n for n, _ in model.named_parameters()]
    groups = TO.stacked_groups(names)
    singles = [k for k in groups if k.startswith(("prefix.", "mtp."))]
    assert "prefix.p0.mixer.w_dq" in singles and "mtp.proj" in singles
    assert "mtp.block.mixer.w_uk" in singles and "mtp.block.ffn.w1" in singles
    assert all(groups[k] == [k] for k in singles)
    assert groups["stack.l0.ffn.w1"] == [f"stack.{k}.l0.ffn.w1"
                                         for k in range(model.cfg.n_periods)]
    assert sorted(groups) == sorted(ref["grads"])


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(ref, kind):
    PF.check_optimizer_update(ref, kind)
