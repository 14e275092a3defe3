"""Shared checks of the MoE, MLA, hybrid, xLSTM, VLM and encoder-decoder
families against the JAX package (imported by ``tests/test_torch_moe.py``,
``test_torch_mla.py``, ``test_torch_mamba.py``, ``test_torch_xlstm.py``,
``test_torch_vlm.py`` and ``test_torch_encdec.py``).

Each family's reduced model runs the same numpy tokens (and patch or
frame embeddings, where the config takes them) on the parameters of the
JAX ``Model`` (carried over by ``params_from_jax``): ``prefill`` (logits
and every cache, the encoder's K/V included) and two greedy ``decode`` steps within ``rtol 2e-3, atol 2e-4`` (the
dense family's tolerance, ``tests/test_torch_dense.py``), ``Model.loss``
(total, ``ce``, ``aux``) within ``1e-5`` relative, and every gradient
leaf within ``1e-4 * max|g| + 1e-7`` (``tests/test_torch_train.py``).  A
module alone is held within ``1e-5 + 1e-5 * max|y|``; an optimizer
update within ``1e-6 * max|leaf|`` (``tests/test_torch_optim.py``).
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.ALL import REDUCED as R_REDUCED
from repro.models.model import Model as RModel
from repro.optim import optimizer as RO
from repro_torch.configs import ALL as TALL
from repro_torch.configs import base as TB
from repro_torch.models.convert import flatten_tree, params_from_jax, stacked_params
from repro_torch.models.model import Model as TModel
from repro_torch.optim import optimizer as TO

SERVE_TOL = dict(rtol=2e-3, atol=2e-4)
LOSS_REL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-7
MODULE_REL = MODULE_ABS = 1e-5
OPT_REL = 1e-6
B, S, STEPS = 2, 32, 2
F32 = dict(act_dtype="float32", param_dtype="float32", remat="none")


def hermetic() -> None:
    """No tuner cache or measurement on either side."""
    os.environ["REPRO_AUTOTUNE_DISABLE"] = "1"
    os.environ["REPRO_TORCH_AUTOTUNE_DISABLE"] = "1"


def cfgs(arch, **kw):
    """(port config, reference config) of ``arch``'s reduced form in
    float32 with ``remat="none"``, with ``kw`` replaced."""
    over = dict(F32, **kw)
    return TALL.REDUCED[arch]().replace(**over), R_REDUCED[arch]().replace(**over)


def as_dict(x):
    """A config dataclass as a plain dict (nested configs too); other
    values as they are."""
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def check_config(mine_mod, ref_mod, full_params: int) -> None:
    """``FULL`` and ``reduced()`` field for field against the reference's,
    and ``param_count()`` equal to the reference's, ``full_params`` for
    ``FULL``."""
    assert TALL.config(mine_mod.FULL.name) is mine_mod.FULL
    for mine, ref in ((mine_mod.FULL, ref_mod.FULL), (mine_mod.reduced(), ref_mod.reduced())):
        for f in dataclasses.fields(TB.ArchConfig):
            if f.name in ("period", "prefix_spec"):
                assert [(s.mixer, s.ffn) for s in getattr(mine, f.name)] == \
                       [(s.mixer, s.ffn) for s in getattr(ref, f.name)], f.name
            else:
                assert as_dict(getattr(mine, f.name)) == as_dict(getattr(ref, f.name)), f.name
        assert mine.hd == ref.hd and mine.n_periods == ref.n_periods
    assert mine_mod.reduced().param_count() == ref_mod.reduced().param_count()
    assert mine_mod.FULL.param_count() == full_params


def embeddings(cfg, seed: int) -> dict:
    """The non-token inputs of ``cfg``'s batch, float32 N(0, 1) from numpy:
    ``patches`` (B, n_patches, d) and ``src_embeds`` (B, S, d) where the
    config takes them."""
    rng = np.random.default_rng(seed + 13)
    out = {}
    if cfg.n_patches:
        out["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["src_embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return out


def nest(flat: dict) -> dict:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def init_params(arch: str, seed: int) -> dict:
    """The reduced model's parameters as the reference's tree of numpy
    arrays, made by the port's ``Model.init`` from ``seed`` (the same
    distributions as the reference's init, which costs seconds of XLA
    compile on the CPU).  Its leaves and shapes are checked against
    ``jax.eval_shape`` of the reference's ``Model.init``."""
    tcfg, rcfg = cfgs(arch)
    model = TModel(tcfg, device="cpu").init(torch.Generator().manual_seed(seed))
    flat = {k: v.numpy() for k, v in stacked_params(model).items()}
    shapes = jax.eval_shape(RModel(rcfg).init, jax.random.PRNGKey(seed))
    want = {jax.tree_util.keystr(path, simple=True, separator="."): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert sorted(flat) == sorted(want)
    for name, leaf in want.items():
        assert flat[name].shape == leaf.shape and flat[name].dtype == leaf.dtype, name
    return nest(flat)


def reference(arch: str, seed: int = 0):
    """The JAX side of one family's reduced model, computed once: numpy
    parameters, tokens and embeddings, prefill logits and caches, the
    decode steps on JAX's greedy tokens (at positions after the prefill's
    last), and the loss, its metrics and gradients.

    Each function runs under ``jax.jit``, lowered here and compiled on a
    worker thread, so that XLA compiles one while the next is traced."""
    hermetic()
    _, rcfg = cfgs(arch)
    rmodel = RModel(rcfg)
    params = jax.tree_util.tree_map(jnp.asarray, init_params(arch, seed))
    rng = np.random.default_rng(seed + 7)
    tokens = rng.integers(0, rcfg.vocab, (B, S + 1)).astype(np.int32)
    extra = embeddings(rcfg, seed)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    prompt = {"tokens": jnp.asarray(tokens[:, :S]), **jextra}
    value_and_grad = jax.value_and_grad(
        lambda p: rmodel.loss(p, {"tokens": jnp.asarray(tokens), **jextra}), has_aux=True)
    step0 = {"tokens": jnp.zeros((B, 1), jnp.int32), "pos": jnp.zeros((B,), jnp.int32)}
    with ThreadPoolExecutor(2) as pool:
        grad = pool.submit(jax.jit(value_and_grad).lower(params).compile)
        prefill = pool.submit(jax.jit(rmodel.prefill).lower(params, prompt).compile)
        logits, caches = prefill.result()(params, prompt)
        decode = jax.jit(rmodel.decode).lower(params, caches, step0).compile()
        tok = np.asarray(jnp.argmax(logits[:, -1], -1))[:, None].astype(np.int32)
        steps = []
        for i in range(STEPS):
            pos = np.full((B,), rcfg.n_patches + S + i, np.int32)
            lg, _ = decode(params, caches, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos)})
            steps.append((tok, pos, np.asarray(lg)))
            tok = np.asarray(lg)[:, -1].argmax(-1)[:, None].astype(np.int32)
        (loss, metrics), grads = grad.result()(params)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(arch=arch, params=np_tree(params), tokens=tokens, extra=extra,
                logits=np.asarray(logits), caches=np_tree(caches), steps=steps,
                loss=float(loss), ce=float(metrics["ce"]), aux=float(metrics["aux"]),
                grads=flatten_tree(np_tree(grads)))


def torch_extra(ref) -> dict:
    """The reference's patch or frame embeddings as CPU tensors."""
    return {k: torch.from_numpy(v) for k, v in ref["extra"].items()}


def port_model(ref, **kw):
    """The port's reduced model on the CPU holding the reference's
    parameters."""
    cfg, _ = cfgs(ref["arch"], **kw)
    return params_from_jax(cfg, ref["params"], device="cpu")


def _caches_close(mine, ref_caches, n_periods: int) -> None:
    """Every cache tensor of every block (``"mixer"`` and, where there is
    one, ``"cross"``) within the serving tolerance."""
    for name, block in ref_caches.get("prefix", {}).items():
        assert sorted(mine["prefix"][name]) == sorted(block)
        for part in block:
            assert len(mine["prefix"][name][part]) == len(block[part])
            for got, want in zip(mine["prefix"][name][part], block[part]):
                np.testing.assert_allclose(got.numpy(), want, **SERVE_TOL)
    for li, block in ref_caches["stack"].items():
        for k in range(n_periods):
            assert sorted(mine["stack"][k][li]) == sorted(block)
            for part in block:
                assert len(mine["stack"][k][li][part]) == len(block[part])
                for got, want in zip(mine["stack"][k][li][part], block[part]):
                    np.testing.assert_allclose(got.numpy(), want[k], **SERVE_TOL)


def check_served(ref) -> None:
    """Prefill (logits and caches) and the greedy decode steps."""
    model = port_model(ref)
    tokens = torch.from_numpy(ref["tokens"][:, :S]).long()
    logits, caches = model.prefill({"tokens": tokens, **torch_extra(ref)})
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **SERVE_TOL)
    _caches_close(caches, ref["caches"], model.cfg.n_periods)
    for tok, pos, want in ref["steps"]:
        lg, _ = model.decode(caches, {"tokens": torch.from_numpy(tok).long(),
                                      "pos": torch.from_numpy(pos).long()})
        np.testing.assert_allclose(lg.numpy(), want, **SERVE_TOL)


def restack(named) -> dict:
    """The port's per-period tensors stacked into the reference's leaves."""
    return {key: (torch.stack([named[n] for n in members]) if TO.is_stacked(key)
                  else named[members[0]]).detach().numpy()
            for key, members in TO.stacked_groups(named).items()}


def check_loss_and_grads(ref) -> None:
    """``Model.loss`` (total, ``ce``, ``aux``) and every gradient leaf."""
    model = port_model(ref).requires_grad_(True)
    total, metrics = model.loss({"tokens": torch.from_numpy(ref["tokens"]).long(),
                                 **torch_extra(ref)})
    assert total.dtype == metrics["aux"].dtype == torch.float32 and total.shape == ()
    for got, want in ((total.detach(), ref["loss"]), (metrics["ce"].detach(), ref["ce"]),
                      (metrics["aux"].detach(), ref["aux"])):
        assert abs(got.item() - want) <= LOSS_REL * abs(want), (got.item(), want)
    cfg = model.cfg
    assert (ref["aux"] > 0) == any(s.ffn == "moe" for s in cfg.prefix_spec + cfg.period)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    mine = restack(grads)
    assert sorted(mine) == sorted(ref["grads"])
    for name, want in ref["grads"].items():
        assert mine[name].shape == want.shape, name
        err = np.abs(mine[name] - want).max()
        assert err <= GRAD_REL * np.abs(want).max() + GRAD_ABS, (name, err)


def module_close(got: torch.Tensor, want) -> None:
    """``|got - want| <= 1e-5 + 1e-5 * max|want|``."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = np.abs(got.detach().numpy().astype(np.float64) - want).max()
    assert err <= MODULE_ABS + MODULE_REL * np.abs(want).max(), err


def load_module(module, tree):
    """Copy a JAX parameter subtree into a port module by its names."""
    want = module.state_dict()
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, tree))
    assert sorted(flat) == sorted(want)
    with torch.no_grad():
        for name, arr in flat.items():
            want[name].copy_(torch.from_numpy(np.array(arr)))
    return module


def check_optimizer_update(ref, kind: str) -> None:
    """One ``kind`` update from the same parameters (the reference's
    model's), state and gradients: parameters and state within
    ``1e-6 * max|leaf|`` of the reference's.  The gradients are
    ``1e-3 * N(0, 1)``, the first update of ``tests/test_torch_optim.py``,
    whose third update holds the clipped path."""
    np_params = ref["params"]
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = port_model(ref)
    rng = np.random.default_rng(11)
    g = jax.tree_util.tree_map(lambda p: (1e-3 * rng.standard_normal(p.shape))
                               .astype(np.float32), np_params)
    ropt = RO.make_optimizer(kind, RO.warmup_cosine(1e-2, 2, 10))
    rp, rs = jax.jit(ropt.update)(jax.tree_util.tree_map(jnp.asarray, g),
                                  ropt.init(params), params, jnp.asarray(0))
    topt = TO.make_optimizer(kind, TO.warmup_cosine(1e-2, 2, 10))
    tp = {n: p.detach().clone() for n, p in model.named_parameters()}
    flat_g = flatten_tree(g)
    tg = {}
    for key, members in TO.stacked_groups(tp).items():
        for k, n in enumerate(members):
            tg[n] = torch.from_numpy(flat_g[key][k] if TO.is_stacked(key) else flat_g[key])
    tp, ts = topt.update(tg, topt.init(tp), tp, 0)
    _leaves_close(restack(tp), flatten_tree(jax.tree_util.tree_map(np.asarray, rp)))
    mine_state = {}
    for top, sub in ts.items():
        for key, leaf in (sub.items() if isinstance(sub, dict) else [("", sub)]):
            if isinstance(leaf, dict):
                mine_state.update({f"{top}.{key}.{s}": t.numpy() for s, t in leaf.items()})
            else:
                mine_state[f"{top}.{key}" if key else top] = leaf.numpy()
    _leaves_close(mine_state, flatten_tree(jax.tree_util.tree_map(np.asarray, rs)))


def _leaves_close(mine: dict, ref: dict) -> None:
    assert sorted(mine) == sorted(ref)
    for name, want in ref.items():
        got = np.asarray(mine[name])
        assert got.shape == want.shape and got.dtype == want.dtype, name
        err = np.abs(got.astype(np.float64) - want).max() if want.size else 0.0
        assert err <= OPT_REL * np.abs(want).max() + 1e-30, (name, err)
