"""The xLSTM mixers and xlstm-350m in the port against the JAX package.

``mlstm_apply`` alone: the train and prefill outputs (the reference runs
one chunkwise computation for both; its prefill is compiled once), the
prefill state ``(C, n, m, conv tail)`` and one decode step on it, at two
chunks of the reduced config's 16 tokens and at 7 tokens (one ragged
chunk, ``L = S``); ``slstm_apply`` alone: prefill and decode; each within
``1e-5 + 1e-5 * max|y|``.  The chunkwise form is also held against the
step-by-step recurrence in the port itself.  The float32 leaves (the mLSTM's gates
``wi``/``wf``, the sLSTM's ``bias``) stay float32 under bfloat16
parameters, as the reference's do.  Then the reduced xlstm (one period:
sLSTM at index 3, mLSTM elsewhere, no FFN): prefill and decode (every
cache), ``Model.loss`` and every gradient (the sLSTM's stacked ``r`` is
5-D), within the tolerances of ``tests/port_family.py``.  Its optimizer
update is in ``tests/test_torch_family_optim.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_family as PF
import port_threads  # noqa: F401  (one torch thread a worker)
from repro.configs import xlstm_350m as RX
from repro.models import xlstm as RXL
from repro_torch.configs import xlstm_350m as TX
from repro_torch.models import xlstm as TXL

ARCH = "xlstm-350m"
# ArchConfig.param_count of FULL in the JAX package
FULL_PARAMS = 528_732_160


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DISABLE", "1")


def test_config_is_the_reference_field_for_field():
    PF.check_config(TX, RX, FULL_PARAMS)
    assert [s.mixer for s in TX.FULL.period] == ["mlstm"] * 3 + ["slstm"] + ["mlstm"] * 4
    assert {s.ffn for s in TX.FULL.period} == {"none"} and TX.FULL.n_periods == 3


@pytest.mark.parametrize("which", ["mlstm", "slstm"])
def test_float32_leaves_under_bfloat16_params(which):
    tcfg, rcfg = PF.cfgs(ARCH)
    rinit = getattr(RXL, f"{which}_init")
    ref = jax.eval_shape(lambda: rinit(jax.random.PRNGKey(0), rcfg, jnp.bfloat16))
    p = getattr(TXL, f"{which}_init")(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert sorted(n for n, _ in p.named_parameters()) == sorted(ref)
    for name, leaf in ref.items():
        assert tuple(p[name].shape) == leaf.shape, name
        assert str(p[name].dtype)[6:] == str(leaf.dtype), name
    if which == "mlstm":
        assert torch.equal(p["skip_scale"], torch.ones(128, dtype=torch.bfloat16))
        assert not p["conv_b"].any() and float(p["wi"].abs().max()) <= 0.04
    else:
        assert not p["bias"].any() and torch.equal(p["w_gn"], torch.ones(64, dtype=torch.bfloat16))


def _apply(fn):
    return jax.jit(fn, static_argnums=1, static_argnames="mode")


def _params(module) -> dict:
    """A port module's parameters (the reference's init) as numpy."""
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def mlstm_case():
    """(port config, JAX params, x, {S: (prefill out, state, decode out,
    decode state)}) at S = 32 (two chunks) and 7 (one ragged chunk)."""
    PF.hermetic()
    tcfg, rcfg = PF.cfgs(ARCH)
    params = _params(TXL.mlstm_init(torch.Generator().manual_seed(3), tcfg))
    x = np.random.default_rng(4).standard_normal((2, 33, rcfg.d_model)).astype(np.float32)
    apply = _apply(RXL.mlstm_apply)
    out = {}
    for s in (32, 7):
        xs, xn = jnp.asarray(x[:, :s]), jnp.asarray(x[:, s:s + 1])
        pre, state = apply(params, rcfg, xs, mode="prefill")
        dec, dstate = apply(params, rcfg, xn, cache=state, mode="decode")
        out[s] = (pre, state, dec, dstate)
    return tcfg, params, x, out


@pytest.mark.parametrize("s", [32, 7])
def test_mlstm_chunkwise_and_decode_match_jax(mlstm_case, s):
    tcfg, params, x, out = mlstm_case
    rpre, rstate, rdec, rdstate = out[s]
    p = PF.load_module(TXL.MLSTM(tcfg, torch.float32, "cpu"), params)
    xs, xn = torch.from_numpy(x[:, :s]), torch.from_numpy(x[:, s:s + 1])
    train, none = TXL.mlstm_apply(p, tcfg, xs, mode="train")
    PF.module_close(train, rpre)
    assert none is None
    pre, state = TXL.mlstm_apply(p, tcfg, xs, mode="prefill")
    PF.module_close(pre, rpre)
    assert len(state) == len(rstate) == 4
    for got, want in zip(state, rstate):
        PF.module_close(got, want)
    dec, dstate = TXL.mlstm_apply(p, tcfg, xn, cache=state, mode="decode")
    PF.module_close(dec, rdec)
    for got, want in zip(dstate, rdstate):
        PF.module_close(got, want)


def test_mlstm_chunkwise_equals_the_recurrence():
    """The chunkwise form from no state (m at -inf) against the step-by-step
    recurrence from the decode cache's start (m at -1e30): the same outputs
    and final state."""
    tcfg, _ = PF.cfgs(ARCH)
    p = TXL.mlstm_init(torch.Generator().manual_seed(6), tcfg)
    x_in = torch.randn((2, 32, 128), generator=torch.Generator().manual_seed(7))
    outs, (c, n, m) = TXL.mlstm_chunkwise(p, tcfg, x_in)
    assert torch.isfinite(outs).all() and torch.isfinite(m).all()
    routs, (rc, rn, rm, _) = TXL.mlstm_recurrent(
        p, tcfg, x_in, TXL.init_mlstm_cache(tcfg, 2, torch.float32, device="cpu"))
    for got, want in ((outs, routs), (c, rc), (n, rn), (m, rm)):
        assert float((got - want).abs().max()) <= 1e-5 + 1e-5 * float(want.abs().max())


@pytest.fixture(scope="module")
def slstm_case():
    PF.hermetic()
    tcfg, rcfg = PF.cfgs(ARCH)
    params = _params(TXL.slstm_init(torch.Generator().manual_seed(9), tcfg))
    # a recurrent kernel large enough that the recurrence moves the gates
    params["r"] *= 4.0
    x = np.random.default_rng(10).standard_normal((2, 13, rcfg.d_model)).astype(np.float32)
    apply = _apply(RXL.slstm_apply)
    pre, state = apply(params, rcfg, jnp.asarray(x[:, :12]), mode="prefill")
    dec, dstate = apply(params, rcfg, jnp.asarray(x[:, 12:]), cache=state, mode="decode")
    return tcfg, params, x, (pre, state, dec, dstate)


def test_slstm_prefill_and_decode_match_jax(slstm_case):
    tcfg, params, x, (rpre, rstate, rdec, rdstate) = slstm_case
    p = PF.load_module(TXL.SLSTM(tcfg, torch.float32, "cpu"), params)
    xs = torch.from_numpy(x)
    train, none = TXL.slstm_apply(p, tcfg, xs[:, :12], mode="train")
    PF.module_close(train, rpre)  # the reference's train and prefill run one loop
    assert none is None
    pre, state = TXL.slstm_apply(p, tcfg, xs[:, :12], mode="prefill")
    PF.module_close(pre, rpre)
    for got, want in zip(state, rstate):
        PF.module_close(got, want)
    dec, dstate = TXL.slstm_apply(p, tcfg, xs[:, 12:], cache=state, mode="decode")
    PF.module_close(dec, rdec)
    assert [t.dtype for t in dstate] == [torch.float32] * 4
    for got, want in zip(dstate, rdstate):
        PF.module_close(got, want)


@pytest.mark.parametrize("which", ["mlstm", "slstm"])
def test_init_caches_match_jax(which):
    tcfg, rcfg = PF.cfgs(ARCH)
    mine = getattr(TXL, f"init_{which}_cache")(tcfg, 3, torch.bfloat16, device="cpu")
    ref = getattr(RXL, f"init_{which}_cache")(rcfg, 3, jnp.bfloat16)
    assert [tuple(t.shape) for t in mine] == [r.shape for r in ref]
    assert [str(t.dtype)[6:] for t in mine] == [str(r.dtype) for r in ref]
    for got, want in zip(mine, ref):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.fixture(scope="module")
def ref():
    return PF.reference(ARCH)


def test_reduced_prefill_and_decode_match_jax(ref):
    PF.check_served(ref)


def test_reduced_loss_and_grads_match_jax(ref):
    PF.check_loss_and_grads(ref)
    assert ref["grads"]["stack.l3.mixer.r"].ndim == 5

