"""The serving slice as a whole: reduced yi-6b in the port against the
JAX package's ``Model`` with the same parameters, carried over by
``models.convert.params_from_jax``.

The JAX prefill runs its Pallas flash kernel in interpret mode, the
port's the kernel's plain PyTorch version, both folded at the same
tile.  Logits and caches agree under rtol = 2e-3, atol = 2e-4, the
tolerance the JAX package's own model tests use for this model
(tests/test_models.py): float32 sums run in another order through two
layers and the unembedding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.configs.ALL import REDUCED as R_REDUCED
from repro.models.model import Model as RModel
from repro_torch.configs.ALL import REDUCED
from repro_torch.kernels import engine
from repro_torch.kernels import flash_attention as TF
from repro_torch.launch import serve
from repro_torch.models.convert import flatten_tree, params_from_jax
from repro_torch.models.model import Model

TOL = dict(rtol=2e-3, atol=2e-4)
B, S, STEPS = 4, 64, 4


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


@pytest.fixture(scope="module")
def pair():
    """(port cfg, JAX cfg, JAX model, JAX params, numpy params)."""
    cfg = REDUCED["yi-6b"]().replace(act_dtype="float32", param_dtype="float32")
    rcfg = R_REDUCED["yi-6b"]().replace(act_dtype="float32", param_dtype="float32",
                                        remat="none")
    rmodel = RModel(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return cfg, rcfg, rmodel, params, np_params


def test_prefill_and_greedy_decode_match_jax(pair, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    cfg, _, rmodel, params, np_params = pair
    model = params_from_jax(cfg, np_params, device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    logits, caches = model.prefill({"tokens": torch.from_numpy(tokens).long()})
    rlogits, rcaches = rmodel.prefill(params, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    for k in range(cfg.n_periods):
        for mine, ref in zip(caches["stack"][k]["l0"]["mixer"],
                             rcaches["stack"]["l0"]["mixer"]):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref[k]), **TOL)

    # Greedy decode against the fixed prefill cache.  Both models are fed
    # the JAX token, so a near tie cannot send them down different paths;
    # the port's own greedy token must equal JAX's wherever JAX's top-2
    # logit margin exceeds 1e-3.
    tok = np.asarray(jnp.argmax(rlogits[:, -1], -1))[:, None].astype(np.int32)
    checked = 0
    for i in range(STEPS):
        pos = np.full((B,), S + i, np.int32)
        lg, _ = model.decode(caches, {"tokens": torch.from_numpy(tok).long(),
                                      "pos": torch.from_numpy(pos).long()})
        rlg, _ = rmodel.decode(params, rcaches, {"tokens": jnp.asarray(tok),
                                                 "pos": jnp.asarray(pos)})
        rlg = np.asarray(rlg)
        np.testing.assert_allclose(lg.numpy(), rlg, **TOL)
        top2 = np.sort(rlg[:, -1], -1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        mine = lg[:, -1].argmax(-1).numpy()
        ref = rlg[:, -1].argmax(-1)
        sure = margin > 1e-3
        assert (mine[sure] == ref[sure]).all(), (i, mine, ref, margin)
        checked += int(sure.sum())
        tok = ref[:, None].astype(np.int32)
    assert checked >= B * STEPS // 2, f"only {checked} decode tokens had a clear margin"


def test_init_cache_matches_jax_layout(pair):
    cfg, _, rmodel, _, _ = pair
    caches = Model(cfg, device="cpu").init_cache(2, 16)
    ref = rmodel.init_cache(2, 16)
    assert len(caches["stack"]) == cfg.n_periods
    for mine, want in zip(caches["stack"][0]["l0"]["mixer"], ref["stack"]["l0"]["mixer"]):
        assert tuple(mine.shape) == tuple(want.shape[1:]) and not mine.any()


def test_params_from_jax_loads_every_leaf(pair):
    cfg, _, _, _, np_params = pair
    model = params_from_jax(cfg, np_params, device="cpu")
    sd = model.state_dict()
    flat = flatten_tree(np_params)
    assert len(sd) == (len(flat) - sum(k.startswith("stack.") for k in flat)
                       + cfg.n_periods * sum(k.startswith("stack.") for k in flat))
    np.testing.assert_array_equal(sd["stack.1.l0.mixer.wq"].numpy(),
                                  np_params["stack"]["l0"]["mixer"]["wq"][1])
    np.testing.assert_array_equal(sd["unembed"].numpy(), np_params["unembed"])


def test_params_from_jax_refuses_bad_trees(pair):
    cfg, _, _, _, np_params = pair

    def tree(**edit):
        t = jax.tree_util.tree_map(lambda a: a, np_params)
        for path, val in edit.items():
            node = t
            keys = path.split("__")
            for key in keys[:-1]:
                node = node[key]
            if val is None:
                del node[keys[-1]]
            else:
                node[keys[-1]] = val
        return t

    with pytest.raises(ValueError, match="shape"):
        params_from_jax(cfg, tree(final_norm__w=np.ones(3, np.float32)), device="cpu")
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(cfg, tree(unembed=None), device="cpu")
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(cfg, tree(extra=np.ones(2, np.float32)), device="cpu")
    with pytest.raises(ValueError, match="n_periods"):
        params_from_jax(cfg, tree(stack__l0__norm1__w=np.ones((1, cfg.d_model),
                                                             np.float32)), device="cpu")


@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_serve_main_returns_the_token_ids(temperature, capsys):
    before = dict(TF.launch_counts(), **engine.launch_counts())
    argv = ["--smoke", "--device", "cpu", "--batch", "4", "--prompt-len", "32", "--gen",
            "3", "--temperature", temperature]
    ids = serve.main(argv)
    assert tuple(ids.shape) == (4, 4)
    assert int(ids.min()) >= 0 and int(ids.max()) < REDUCED["yi-6b"]().vocab
    assert torch.equal(ids, serve.main(argv))  # the seed fixes weights, prompts, samples
    out = capsys.readouterr().out
    assert "prefill 32 tokens x 4" in out and "tok/s" in out
    assert dict(TF.launch_counts(), **engine.launch_counts()) == before


def test_serve_greedy_tokens_follow_the_prefill_logits():
    r = serve.run(serve.parse_args(["--smoke", "--device", "cpu", "--gen", "2",
                                    "--temperature", "0"]))
    assert torch.equal(r.tokens[:, 0], r.prefill_logits[:, -1].argmax(-1).cpu())
    logits, _ = r.model.prefill({"tokens": r.prompts})
    assert torch.equal(logits, r.prefill_logits)


def test_entry_points_need_a_card_by_default(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    cfg, _, _, _, np_params = pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(cfg, np_params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--gen", "1"])


def test_unported_configs_raise(pair, capsys):
    """No architecture is refused any more: the three last families serve
    their reduced configs on the CPU, with patches or frame embeddings in
    the prefill batch; an unknown block still raises."""
    cfg = pair[0]
    with pytest.raises(ValueError, match="unknown block"):
        Model(cfg.replace(period=(type(cfg.period[0])("rnn", "dense"),)), device="cpu")
    for arch, extra in (("xlstm-350m", None), ("qwen2-vl-72b", "patches"),
                        ("seamless-m4t-large-v2", "src_embeds")):
        argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--gen", "2",
                "--prompt-len", "32", "--temperature", "0"]
        tokens = serve.main(argv)
        assert tokens.shape == (2, 3) and int(tokens.max()) < 512
        r = serve.run(serve.parse_args(argv))
        assert torch.equal(r.tokens, tokens)
        n_patches = r.model.cfg.n_patches
        assert r.prompts.shape == (2, 32 - n_patches) and r.inputs["tokens"] is r.prompts
        assert sorted(r.inputs) == sorted(["tokens"] + ([extra] if extra else []))
        if extra:
            assert r.inputs[extra].dtype == torch.float32
            assert r.inputs[extra].shape == (2, n_patches or 32, r.model.cfg.d_model)
    assert "prefill 32 tokens x 2" in capsys.readouterr().out
