"""The MoE FFN and qwen2-moe-a2.7b in the port against the JAX package.

The dispatch's integers first: the same numpy router logits through the
reference's ``_route`` and ``_dispatch_compute_combine`` and through the
port's ``route`` and ``dispatch`` give the same expert ids, positions,
keep mask and slots, bit for bit, for the softmax and the sigmoid router,
also at ``capacity_factor=0.5``, where slots are dropped (the drop count
is the reference's).  The reference keeps those integers inside
``_dispatch_compute_combine``; the test reads them by wrapping the
``jnp.where`` and ``jnp.take_along_axis`` that make them.  Then
``moe_apply`` (output and balance loss) within ``1e-5 + 1e-5 * max|y|``,
and the reduced qwen2-moe model's serving, loss and gradients within the
tolerances of ``tests/port_family.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_family as PF
import port_threads  # noqa: F401  (one torch thread a worker)
from repro.configs import qwen2_moe_a27b as RQ
from repro.models import moe as RM
from repro_torch.configs import qwen2_moe_a27b as TQ
from repro_torch.models import moe as TM
from repro_torch.models.convert import flatten_tree, load_stacked, params_from_jax, stacked_params
from repro_torch.models.model import Model

ARCH = "qwen2-moe-a2.7b"
# ArchConfig.param_count of FULL in the JAX package
FULL_PARAMS = 14_315_587_584


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DISABLE", "1")


def test_config_is_the_reference_field_for_field():
    PF.check_config(TQ, RQ, FULL_PARAMS)
    assert (TQ.FULL.hd, TQ.FULL.n_heads, TQ.FULL.n_kv_heads) == (128, 16, 16)


class _Spy:
    """``jnp`` with the two calls that make the dispatch's integers
    recorded: ``take_along_axis`` gives ``pos`` (k, T, 1) and ``where``
    takes ``keep`` and gives ``slot``."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def take_along_axis(self, *a, **kw):
        out = jnp.take_along_axis(*a, **kw)
        self.seen["pos"] = np.asarray(out)[..., 0].T
        return out

    def where(self, cond, *a):
        out = jnp.where(cond, *a)
        self.seen["keep"], self.seen["slot"] = np.asarray(cond), np.asarray(out)
        return out


def _moe_cfg(router, cf):
    """(port, reference) reduced configs with the ``router``'s experts
    (qwen2-moe's softmax, deepseek-v3's sigmoid) at capacity factor ``cf``."""
    arch = "deepseek-v3-671b" if router == "sigmoid" else ARCH
    return tuple(c.replace(moe=dataclasses.replace(c.moe, capacity_factor=cf))
                 for c in PF.cfgs(arch))


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_dispatch_integers_are_the_reference_bit_for_bit(router, cf, monkeypatch):
    tcfg, rcfg = _moe_cfg(router, cf)
    mc = rcfg.moe
    t, d = 96, 8
    rng = np.random.default_rng(5)
    logits = (2 * rng.standard_normal((t, mc.n_experts))).astype(np.float32)
    x2 = rng.standard_normal((t, d)).astype(np.float32)
    rgates, ridx, rprobs = RM._route(jnp.asarray(logits), mc)
    spy = _Spy()
    monkeypatch.setattr(RM, "jnp", spy)
    sub = {w: jnp.zeros((mc.n_experts,) + sh, jnp.float32)
           for w, sh in (("w1", (d, 4)), ("w3", (d, 4)), ("w2", (4, d)))}
    RM._dispatch_compute_combine(jnp.asarray(x2), rgates, ridx, rprobs, sub, mc, jnp.float32,
                                 None)
    gates, idx, probs = TM.route(torch.from_numpy(logits), tcfg.moe)
    pos, keep, slot, cap = TM.dispatch(idx, tcfg.moe)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert np.array_equal(pos.numpy(), spy.seen["pos"])
    assert np.array_equal(keep.numpy(), spy.seen["keep"])
    assert np.array_equal(slot.numpy(), spy.seen["slot"])
    assert cap == TM.capacity(t, tcfg.moe) == max(int(np.ceil(t * mc.top_k / mc.n_experts
                                                               * cf)), 4)
    drops = int((~keep).sum())
    assert drops == int((~spy.seen["keep"]).sum())
    assert (drops > 0) == (cf < 1)
    np.testing.assert_allclose(gates.numpy(), np.asarray(rgates), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_apply_matches_jax(router):
    tcfg, rcfg = _moe_cfg(router, 1.25)
    params = RM.moe_init(jax.random.PRNGKey(2), rcfg, jnp.float32)
    x = np.random.default_rng(3).standard_normal((2, 24, rcfg.d_model)).astype(np.float32)
    rout, raux = jax.jit(RM.moe_apply, static_argnums=1)(params, rcfg, jnp.asarray(x))
    p = PF.load_module(TM.MoE(tcfg, torch.float32, "cpu"), params)
    assert p["router"].dtype == torch.float32 and ("shared" in p._modules) == bool(
        tcfg.moe.n_shared)
    out, aux = TM.moe_apply(p, tcfg, torch.from_numpy(x))
    PF.module_close(out, rout)
    PF.module_close(aux, raux)
    assert float(aux) > 0


def test_record_routing_sees_every_moe_layer():
    tcfg, _ = PF.cfgs(ARCH)
    m = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, tcfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    with TM.record_routing() as ids:
        m.prefill({"tokens": tokens})
    assert len(ids) == tcfg.n_layers and TM._RECORD is None
    assert all(tuple(i.shape) == (32, tcfg.moe.top_k) for i in ids)


@pytest.fixture(scope="module")
def ref():
    return PF.reference(ARCH)


def test_reduced_prefill_and_decode_match_jax(ref):
    PF.check_served(ref)


def test_reduced_loss_and_grads_match_jax(ref):
    PF.check_loss_and_grads(ref)


def test_expert_leaves_load_stacked_and_refuse_a_missing_one(ref):
    cfg, _ = PF.cfgs(ARCH)
    model = params_from_jax(cfg, ref["params"], device="cpu")
    flat = flatten_tree(ref["params"])
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.expert_ff
    assert flat["stack.l0.ffn.w1"].shape == (cfg.n_periods, e, d, f)
    back = stacked_params(model)
    assert sorted(back) == sorted(flat)
    for name, arr in flat.items():
        assert np.array_equal(back[name].numpy(), arr), name
    for drop in ("stack.l0.ffn.w2", "stack.l0.ffn.shared.w1"):
        short = {k: v for k, v in flat.items() if k != drop}
        with pytest.raises(ValueError, match="missing"):
            load_stacked(model, short)
    with pytest.raises(ValueError, match="extra"):
        load_stacked(model, dict(flat, **{"stack.l0.ffn.w4": flat["stack.l0.ffn.w1"]}))
    with pytest.raises(ValueError, match="shape"):
        load_stacked(model, dict(flat, **{"stack.l0.ffn.w1": flat["stack.l0.ffn.w1"][:, :-1]}))
