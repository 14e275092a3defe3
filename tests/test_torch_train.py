"""The training path's forward and backward against the JAX package's:
``Model.loss`` and its gradients, remat, and attention under autograd.

``Model.loss`` of reduced yi-6b and internlm2-20b (two periods each; its
GQA group is 3) takes the same numpy tokens and the parameters of the
JAX ``Model`` (``params_from_jax``): the loss within ``1e-5`` relative of
JAX's, every gradient leaf, its periods stacked back, within ``1e-4 *
max|g| + 1e-7`` of ``jax.grad``'s (float32 sums run in another order
through two layers).  The JAX loss runs its flash forward in interpret
mode under the custom VJP, the port's the plain version under
``FlashFunction``.  ``FlashFunction``'s gradients equal autograd through
``_reference_attention`` bit for bit on the CPU (the backward runs those
very ops); the chunked executor's within ``1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)
from repro.configs.ALL import REDUCED as R_REDUCED
from repro.kernels import flash_attention as RF
from repro.models.model import Model as RModel
from repro_torch.configs.ALL import REDUCED
from repro_torch.kernels import flash_attention as TF
from repro_torch.models import attention as TA
from repro_torch.models.convert import flatten_tree, params_from_jax
from repro_torch.optim.optimizer import stacked_groups

B, S = 2, 48
LOSS_REL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-7


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DISABLE", "1")


def _cfgs(arch, **kw):
    over = dict(act_dtype="float32", param_dtype="float32", remat="none")
    over.update(kw)
    return REDUCED[arch]().replace(**over), R_REDUCED[arch]().replace(**over)


@pytest.fixture(scope="module", params=["yi-6b", "internlm2-20b"])
def ref(request):
    """(arch, numpy params, tokens, JAX loss, JAX grads by stacked name),
    the JAX side computed once per architecture."""
    import os

    os.environ["REPRO_AUTOTUNE_DISABLE"] = "1"
    _, rcfg = _cfgs(request.param)
    rmodel = RModel(rcfg)
    params = jax.jit(rmodel.init)(jax.random.PRNGKey(1))
    tokens = np.random.default_rng(2).integers(0, rcfg.vocab, (B, S + 1)).astype(np.int32)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: rmodel.loss(p, {"tokens": jnp.asarray(tokens)}), has_aux=True))(params)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return (request.param, np_params, tokens, float(loss), float(metrics["aux"]),
            flatten_tree(jax.tree_util.tree_map(np.asarray, grads)))


def _port_loss_and_grads(arch, np_params, tokens, **cfg_kw):
    cfg, _ = _cfgs(arch, **cfg_kw)
    model = params_from_jax(cfg, np_params, device="cpu").requires_grad_(True)
    total, metrics = model.loss({"tokens": torch.from_numpy(tokens).long()})
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    return model, total, metrics, grads


def _restack(grads):
    return {key: (torch.stack([grads[n] for n in members]) if key.startswith("stack.")
                  else grads[members[0]]).numpy()
            for key, members in stacked_groups(grads).items()}


def test_loss_and_grads_match_jax(ref):
    arch, np_params, tokens, rloss, raux, rgrads = ref
    model, total, metrics, grads = _port_loss_and_grads(arch, np_params, tokens)
    assert model.cfg.n_periods >= 2
    assert total.dtype == metrics["ce"].dtype == torch.float32 and total.shape == ()
    assert float(metrics["aux"]) == raux == 0.0
    assert abs(total.item() - rloss) <= LOSS_REL * abs(rloss)
    assert torch.equal(total.detach(), (metrics["ce"] + metrics["aux"]).detach())
    mine = _restack(grads)
    assert sorted(mine) == sorted(rgrads)
    for name, want in rgrads.items():
        assert mine[name].shape == want.shape, name
        err = np.abs(mine[name] - want).max()
        assert err <= GRAD_REL * np.abs(want).max() + GRAD_ABS, (name, err)


def test_remat_full_equals_none(ref):
    """Remat recomputes each period in the backward: the same loss and
    the same gradients, bit for bit on the CPU."""
    arch, np_params, tokens, *_ = ref
    _, l_none, _, g_none = _port_loss_and_grads(arch, np_params, tokens, remat="none")
    _, l_full, _, g_full = _port_loss_and_grads(arch, np_params, tokens, remat="full")
    assert torch.equal(l_none, l_full)
    for name in g_none:
        assert torch.equal(g_none[name], g_full[name]), name


def test_remat_dots_is_queued_and_serving_stays_grad_free(ref):
    """remat "dots" saves the unbatched matrix products and recomputes the
    rest: the loss and every gradient leaf equal "none"'s within ``1e-6 *
    max|g|`` (bit for bit on the CPU); serving records no graph under it,
    and an unknown remat is refused."""
    arch, np_params, tokens, *_ = ref
    _, l_none, _, g_none = _port_loss_and_grads(arch, np_params, tokens, remat="none")
    model, l_dots, _, g_dots = _port_loss_and_grads(arch, np_params, tokens, remat="dots")
    assert abs(l_dots.item() - l_none.item()) <= 1e-6 * abs(l_none.item())
    for name, want in g_none.items():
        err = (g_dots[name] - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item(), (name, err)
    batch = {"tokens": torch.from_numpy(tokens).long()}
    model.requires_grad_(False)
    assert not any(p.requires_grad for p in model.parameters())
    logits, caches = model.prefill({"tokens": batch["tokens"][:, :-1]})
    assert logits.grad_fn is None and not logits.requires_grad
    with pytest.raises(ValueError, match="remat"):
        model.cfg = model.cfg.replace(remat="some")
        model.requires_grad_(True).loss(batch)


def test_remat_dots_saves_between_none_and_full(ref, monkeypatch):
    """The tensors kept for the backward: those autograd saves outside a
    checkpoint (counted by ``saved_tensors_hooks``) plus the products the
    "dots" policy saves.  "full" keeps only the former, "none" every op's
    inputs, "dots" the projections' outputs besides: strictly between."""
    from repro_torch.models import transformer as TT

    arch, np_params, tokens, *_ = ref
    policy_saves = []
    save_dots = TT._save_dots

    def counting(ctx, op, *args, **kwargs):
        decision = save_dots(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and decision == TT.CheckpointPolicy.MUST_SAVE:
            policy_saves.append(op)
        return decision

    monkeypatch.setattr(TT, "_save_dots", counting)
    cfg, _ = _cfgs(arch)
    model = params_from_jax(cfg, np_params, device="cpu").requires_grad_(True)
    batch = {"tokens": torch.from_numpy(tokens).long()}
    kept = {}
    for remat in ("none", "full", "dots"):
        model.cfg = cfg.replace(remat=remat)
        packed = []
        policy_saves.clear()
        with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(1) or t,
                                                      lambda t: t):
            total, _ = model.loss(batch)
        torch.autograd.grad(total, list(model.parameters()))
        kept[remat] = len(packed) + len(policy_saves)
        if remat == "dots":
            # per layer: q, k, v, the output projection and the FFN's three
            assert len(policy_saves) == 7 * cfg.n_layers
            assert set(policy_saves) <= set(TT._DOTS)
    assert kept["full"] < kept["dots"] < kept["none"], kept


def test_cross_entropy_is_float32_logsumexp():
    from repro.models.model import _cross_entropy as r_ce
    from repro_torch.models.model import _cross_entropy as t_ce

    rng = np.random.default_rng(4)
    logits = (30 * rng.standard_normal((2, 5, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    got = t_ce(torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels))
    want = r_ce(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# ------------------------------------------------------- attention under autograd


def _qkv(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).requires_grad_(True)
            for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


# (b, hq, hkv, s, d, block, kind, bias lead dims, segments)
FLASH_CASES = [
    (2, 4, 2, 64, 16, 16, "folded", None, False),
    (1, 6, 2, 48, 16, 16, "bb", (1, 6), True),
    (2, 4, 1, 64, 32, 32, "folded", (2, 1), True),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_function_grads_equal_reference_autograd(case):
    b, hq, hkv, s, d, bq, kind, lead, with_seg = case
    q, k, v = _qkv(b, hq, hkv, s, d, seed=s + hq)
    rng = np.random.default_rng(d)
    bias = None if lead is None else torch.from_numpy(
        rng.standard_normal(lead + (s, s)).astype(np.float32)).requires_grad_(True)
    seg = None
    if with_seg:
        seg = torch.zeros((b, s), dtype=torch.int32)
        seg[0, s // 3:] = 1
        seg[-1, (2 * s) // 3 + 5:] = 2
    cot = torch.from_numpy(rng.standard_normal((b, hq, s, d)).astype(np.float32))
    out = TF.flash_attention(q, k, v, bias=bias, segment_ids=seg, kind=kind, block_q=bq,
                             block_kv=bq, device="cpu")
    assert out.grad_fn.name() == "FlashFunctionBackward"
    wrt = [q, k, v] + ([bias] if bias is not None else [])
    got = torch.autograd.grad(out, wrt, cot)
    ref_out = TF._reference_attention(q, k, v, bias, seg, d**-0.5)
    want = torch.autograd.grad(ref_out, wrt, cot)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_flash_function_only_where_a_gradient_is_needed():
    q, k, v = (t.detach() for t in _qkv(1, 2, 1, 32, 16, seed=0))
    plain = TF.flash_attention(q, k, v, block_q=16, block_kv=16, device="cpu")
    assert plain.grad_fn is None
    k.requires_grad_(True)
    out = TF.flash_attention(q, k, v, block_q=16, block_kv=16, device="cpu")
    assert torch.equal(out, plain)
    (dk,) = torch.autograd.grad(out.sum(), [k])
    assert dk.shape == k.shape
    with torch.no_grad():
        assert TF.flash_attention(q, k, v, block_q=16, block_kv=16, device="cpu").grad_fn is None


def test_flash_grads_match_jax_custom_vjp():
    """The port's backward against the reference's ``_flash_core`` VJP in
    interpret mode, with a per-head bias."""
    b, hq, hkv, s, d = 1, 4, 2, 32, 16
    rng = np.random.default_rng(8)
    qn, kn, vn = (rng.standard_normal(sh).astype(np.float32)
                  for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    bn = rng.standard_normal((1, hq, s, s)).astype(np.float32)
    cot = rng.standard_normal((b, hq, s, d)).astype(np.float32)

    def jfn(q, k, v, bias):
        return RF.flash_attention(q, k, v, bias=bias, block_q=16, block_kv=16, interpret=True)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (qn, kn, vn, bn)))
    want = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (qn, kn, vn, bn)]
    out = TF.flash_attention(ts[0], ts[1], ts[2], bias=ts[3], block_q=16, block_kv=16,
                             device="cpu")
    got = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("schedule", ["folded", "bb"])
@pytest.mark.parametrize("s,chunk,hq,hkv", [(64, 16, 4, 2), (48, 16, 6, 2)])
def test_chunked_executor_grads_match_reference(s, chunk, hq, hkv, schedule):
    """The chunked executor (the prefill of a head dim no flash tile
    takes) is differentiable as it is, its flushes by indexed assignment
    included."""
    q, k, v = _qkv(2, hq, hkv, s, 16, seed=s)
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal(q.shape).astype(np.float32))
    out = TA.chunked_causal_attention(q, k, v, chunk=chunk, schedule=schedule)
    got = torch.autograd.grad(out, [q, k, v], cot)
    want = torch.autograd.grad(TF._reference_attention(q, k, v, None, None, 16**-0.5),
                               [q, k, v], cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
