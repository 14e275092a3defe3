"""The training slice's substrate against the JAX package's: AdamW and
Adafactor, gradient clipping, the learning-rate schedule, the synthetic
data and the checkpoints.

The optimizers start from the same numpy parameters, state and gradients
(reduced yi-6b for AdamW, reduced internlm2-20b for Adafactor, each with
two periods, so the stacked-leaf rules act across periods) and take one
and three updates; parameters and state agree within ``1e-6 * max|leaf|``
of the reference's, leaf by leaf, after the port's per-period tensors are
stacked back.  Both sides compute in float32; ``pow``, ``cos`` and the
sums of the global norm may round differently.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)
from repro.checkpoint import checkpointing as RC
from repro.configs.ALL import REDUCED as R_REDUCED
from repro.data import pipeline as RD
from repro.models.model import Model as RModel
from repro.optim import optimizer as RO
from repro_torch.checkpoint import checkpointing as TC
from repro_torch.configs.ALL import REDUCED
from repro_torch.data.pipeline import SyntheticLM, host_shard
from repro_torch.models.convert import flatten_tree, params_from_jax
from repro_torch.optim import optimizer as TO

REL = 1e-6
PERIODS = 2
OPTIMIZER_ARCH = {"adamw": "yi-6b", "adafactor": "internlm2-20b"}


def _restacked(named):
    """The port's per-period tensors stacked into the reference's leaves."""
    return {key: (torch.stack([named[n] for n in members]) if key.startswith("stack.")
                  else named[members[0]]).detach().numpy()
            for key, members in TO.stacked_groups(named).items()}


def _close(mine: dict, ref: dict, what: str) -> None:
    assert sorted(mine) == sorted(ref), what
    for name, want in ref.items():
        want = np.asarray(want)
        got = np.asarray(mine[name])
        assert got.shape == want.shape and got.dtype == want.dtype, (what, name)
        err = np.abs(got.astype(np.float64) - want).max() if want.size else 0.0
        assert err <= REL * np.abs(want).max() + 1e-30, (what, name, err)


@pytest.fixture(scope="module", params=sorted(OPTIMIZER_ARCH))
def setup(request):
    """(kind, lr, JAX params, port model, numpy grads per update)."""
    kind = request.param
    arch = OPTIMIZER_ARCH[kind]
    over = dict(act_dtype="float32", param_dtype="float32", n_layers=PERIODS)
    rcfg = R_REDUCED[arch]().replace(**over)
    params = jax.jit(RModel(rcfg).init)(jax.random.PRNGKey(3))
    model = params_from_jax(REDUCED[arch]().replace(**over),
                            jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(11)
    # the third update's gradients are large, so the clip acts there
    grads = [jax.tree_util.tree_map(
        lambda p, s=s: (s * rng.standard_normal(p.shape)).astype(np.float32), params)
        for s in (1e-3, 2e-2, 30.0)]
    return kind, RO.warmup_cosine(1e-2, 2, 10), params, model, grads


@pytest.mark.parametrize("updates", [1, 3])
def test_optimizer_matches_jax(setup, updates):
    kind, lr, params, model, grads = setup
    ropt = RO.make_optimizer(kind, lr)
    rupdate = jax.jit(ropt.update)
    topt = TO.make_optimizer(kind, TO.warmup_cosine(1e-2, 2, 10))
    rp, rs = params, ropt.init(params)
    tp = {n: p.detach().clone() for n, p in model.named_parameters()}
    ts = topt.init(tp)
    for step in range(updates):
        g = grads[step]
        rp, rs = rupdate(jax.tree_util.tree_map(jnp.asarray, g), rs, rp, jnp.asarray(step))
        flat_g = flatten_tree(g)
        tg = {}
        for key, members in TO.stacked_groups(tp).items():
            for k, n in enumerate(members):
                tg[n] = torch.from_numpy(flat_g[key][k] if key.startswith("stack.")
                                         else flat_g[key])
        tp, ts = topt.update(tg, ts, tp, step)
    _close(_restacked(tp), flatten_tree(jax.tree_util.tree_map(np.asarray, rp)), "params")
    ref_state = flatten_tree(jax.tree_util.tree_map(np.asarray, rs))
    mine_state = {}
    for top, sub in ts.items():
        if isinstance(sub, dict):
            for key, leaf in sub.items():
                if isinstance(leaf, dict):
                    mine_state.update({f"{top}.{key}.{s}": t.numpy() for s, t in leaf.items()})
                else:
                    mine_state[f"{top}.{key}"] = leaf.numpy()
        else:
            mine_state[top] = sub.numpy()
    _close(mine_state, ref_state, "state")


def test_stacked_leaf_rules_span_the_periods(setup):
    """The three shape rules act on the stacked leaf: a per-period port
    would not decay the norm weights, would keep their second moment
    unfactored and would clip each period's update alone."""
    kind, _, params, model, _ = setup
    names = [n for n, _ in model.named_parameters()]
    groups = TO.stacked_groups(names)
    assert groups["stack.l0.norm1.w"] == [f"stack.{k}.l0.norm1.w" for k in range(PERIODS)]
    state = TO.make_optimizer(kind, lambda s: 1e-3).init(dict(model.named_parameters()))
    d = model.cfg.d_model
    if kind == "adafactor":
        assert state["f"]["stack.l0.norm1.w"]["vr"].shape == (PERIODS,)
        assert state["f"]["stack.l0.norm1.w"]["vc"].shape == (d,)
        assert state["f"]["final_norm.w"]["v"].shape == (d,)
    else:
        assert state["m"]["stack.l0.norm1.w"].shape == (PERIODS, d)
    # decay: with zero gradients only the decay moves a parameter
    lr = 1e-2
    opt = TO.make_optimizer(kind, lambda s: torch.tensor(lr))
    tp = {n: p.detach().clone() for n, p in model.named_parameters()}
    before = {n: p.clone() for n, p in tp.items()}
    tp, _ = opt.update({n: torch.zeros_like(p) for n, p in tp.items()}, opt.init(tp), tp, 0)
    decayed = torch.tensor(1.0) - torch.tensor(lr) * 0.1
    assert torch.equal(tp["stack.1.l0.norm1.w"], before["stack.1.l0.norm1.w"] * decayed)
    assert torch.equal(tp["final_norm.w"], before["final_norm.w"])


def test_clip_by_global_norm_matches_jax():
    g = {"x": np.full((4,), 100.0, np.float32), "y": np.arange(6, dtype=np.float32)}
    mine, gn = TO.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    ref, rgn = RO.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    assert float(gn) == pytest.approx(float(rgn), rel=1e-7)
    for k in g:
        np.testing.assert_allclose(mine[k].numpy(), np.asarray(ref[k]), rtol=1e-6)
    assert abs(float(torch.linalg.norm(torch.cat([t for t in mine.values()]))) - 1.0) < 1e-5
    small, _ = TO.clip_by_global_norm({"x": torch.ones(2)}, 10.0)
    assert torch.equal(small["x"], torch.ones(2))


def test_warmup_cosine_matches_jax():
    for peak, warmup, total in ((3e-3, 11, 100), (1e-2, 1, 5), (1.0, 2, 2)):
        mine, ref = TO.warmup_cosine(peak, warmup, total), RO.warmup_cosine(peak, warmup, total)
        for step in range(0, total + 3):
            got = mine(step)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(ref(jnp.asarray(step))), rel=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="adafactor"):
        TO.make_optimizer("sgd", TO.warmup_cosine(1e-3, 1, 10))


# ------------------------------------------------------------------- data


def test_synthetic_lm_deterministic_per_seed_and_step():
    d1 = SyntheticLM(1000, 32, 8, seed=3, device="cpu")
    d2 = SyntheticLM(1000, 32, 8, seed=3, device="cpu")
    b5 = d1.batch_at(5)["tokens"]
    for s in (0, 1, 2):
        d2.batch_at(s)  # another call history
    assert torch.equal(b5, d2.batch_at(5)["tokens"])
    assert not torch.equal(b5, d1.batch_at(6)["tokens"])
    assert not torch.equal(b5, SyntheticLM(1000, 32, 8, seed=4, device="cpu").batch_at(5)["tokens"])


def test_synthetic_lm_shape_range_and_copy_rate():
    """Zipf unigrams over min(vocab, 4096) symbols and the copy mask: the
    share of tokens equal to the one four back, and of the most frequent
    symbol, within 0.02 of the JAX package's stream (each about 0.26 and
    0.17 over 8 x 1025 tokens)."""
    for vocab in (512, 64000):
        t = SyntheticLM(vocab, 1024, 8, seed=1, device="cpu").batch_at(0)["tokens"]
        r = np.asarray(RD.SyntheticLM(vocab, 1024, 8, seed=1).batch_at(0)["tokens"])
        assert t.shape == r.shape == (8, 1025) and t.dtype == torch.int64
        assert int(t.min()) >= 0 and int(t.max()) < min(vocab, 4096)
        t = t.numpy()
        for stat in (lambda x: (x[:, 4:] == x[:, :-4]).mean(), lambda x: (x == 0).mean()):
            assert abs(stat(t) - stat(r)) < 0.02, (stat(t), stat(r))
    plain = SyntheticLM(512, 1024, 8, seed=1, structured=False, device="cpu").batch_at(0)
    assert (plain["tokens"][:, 4:] == plain["tokens"][:, :-4]).float().mean().item() < 0.1


def test_host_shard_partitions_batch():
    b = SyntheticLM(100, 16, 8, device="cpu").batch_at(0)
    parts = [host_shard(b, i, 4)["tokens"] for i in range(4)]
    assert all(p.shape[0] == 2 for p in parts)
    assert torch.equal(torch.cat(parts), b["tokens"])


# ------------------------------------------------------------ checkpoints


def test_checkpoint_roundtrip_and_atomicity():
    tree = {
        "params": {"w": torch.arange(12.0).reshape(3, 4),
                   "stack": (torch.ones((2, 2)), torch.zeros(3))},
        "opt": {"m": {"w": torch.full((3, 4), 0.5)}, "gnorm": torch.tensor(2.5)},
    }
    with tempfile.TemporaryDirectory() as d:
        TC.save(d, 3, tree)
        TC.save(d, 5, tree)
        assert TC.list_steps(d) == [3, 5]
        got, step = TC.restore_latest(d, tree)
        assert step == 5
        assert isinstance(got["params"]["stack"], tuple)
        for a, b in zip(TC._flatten(got).values(), TC._flatten(tree).values()):
            assert a.dtype == b.dtype and torch.equal(a, b)
        # a crash mid-save: the .tmp directory is never picked up
        os.makedirs(os.path.join(d, "step_00000009.tmp"))
        assert TC.latest_step(d) == 5
        # a corrupt LATEST pointer: the newest complete checkpoint
        with open(os.path.join(d, "LATEST"), "w") as f:
            f.write("garbage")
        assert TC.latest_step(d) == 5
        with pytest.raises(ValueError, match="shape"):
            TC.restore(d, 5, {"params": {"w": torch.zeros(4, 3)}})
        assert TC.restore_latest(os.path.join(d, "none"), tree) == (None, None)


def test_checkpoint_layout_is_the_reference_s():
    """Each package restores what the other wrote."""
    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "c": [np.int32(7), np.ones(2, np.float32)]}
    with tempfile.TemporaryDirectory() as d:
        RC.save(d, 2, jax.tree_util.tree_map(jnp.asarray, tree))
        TC.save(d, 4, {"a": {"b": torch.from_numpy(tree["a"]["b"]) + 1},
                       "c": [torch.tensor(8, dtype=torch.int32), torch.zeros(2)]})
        with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
            ref_manifest = f.read()
        with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
            mine_manifest = f.read()
        assert ref_manifest.replace('"step": 2', "") == mine_manifest.replace('"step": 4', "")
        proto = {"a": {"b": torch.zeros(2, 3)}, "c": [torch.tensor(0, dtype=torch.int32),
                                                      torch.zeros(2)]}
        got = TC.restore(d, 2, proto)
        assert torch.equal(got["a"]["b"], torch.from_numpy(tree["a"]["b"]))
        assert int(got["c"][0]) == 7 and got["c"][0].dtype == torch.int32
        back, step = RC.restore_latest(d, jax.tree_util.tree_map(jnp.asarray, tree))
        assert step == 4
        np.testing.assert_array_equal(np.asarray(back["a"]["b"]), tree["a"]["b"] + 1)


@pytest.mark.parametrize("mod", [TO, TC, SyntheticLM.__module__], ids=str)
def test_substrate_doctests(mod):
    import doctest
    import importlib

    mod = importlib.import_module(mod) if isinstance(mod, str) else mod
    result = doctest.testmod(mod, verbose=False)
    assert result.failed == 0 and result.attempted > 0
