"""The LM half of distribution on 4 gloo ranks against the JAX package.

One module fixture writes the inputs (the port's initialised weights of
reduced yi-6b and qwen2-moe-a2.7b, tokens, activations) to ``setup.npz``,
then runs these at once: a 4-rank gloo group of the port (rank program
``tests/port_lm_spmd.py``, meeting through a ``FileStore``), two JAX
subprocesses with four host devices each running the reference's own
mesh paths on a (2, 2) mesh (``tests/port_lm_jax.py``: its mesh forms
and train step, and its serve steps), and, in this process, the
reference's single-device loss and optimizer run per data shard.  The
bundle's train step updates each rank's shards (ZeRO-3): it is also held
against the gathered update of the same step (the rank program's plain
version), and a dispatch mode records what the update allocates.

Tolerances: the mesh forms of attention and the MoE within ``1e-5``
(the attention tolerance; the port attends through ``simplex_attention``,
the reference through the chunked executor, which agree to ~5e-7); the
reduced yi-6b train step's loss within ``rtol 2e-4`` of ``jit_train``'s
(the reference test's own gate) and every updated parameter within
``1e-6 * max|leaf|``; the optimizer's first moment (0.1 x the clipped
gradient) or Adafactor's statistics within ``1e-5 * max|leaf|`` and the gradient norm within ``1e-5``
relative, which neither a gradient multiplied by ``|model|`` nor one left
partial meets; with ``gather_dtype="bfloat16"`` the gradients are
bfloat16 on both sides, so ``m`` within ``4e-3 * max|m|`` (a bfloat16
rounding) and the norm within ``1e-4``; the MoE balance loss ``aux``
equal; serving (the reference's prefill and decode steps on the same
mesh, and the port's mesh-less path) within ``rtol 2e-3, atol 2e-4``
with every argmax equal (the dense family's gate).  The sharded update
against the gathered one: AdamW bit for bit where the clip's scale is
exactly 1; otherwise every parameter and state shard within
``1e-6 * max|leaf|`` and the gradient norm within ``rtol 1e-6`` (the
partial sums' order).
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import port_lm_spmd as P
import port_threads  # noqa: F401  (one torch thread a worker)

from repro.configs.ALL import REDUCED as R_REDUCED
from repro.models.model import Model as RModel
from repro.optim import optimizer as RO
from repro_torch.configs.ALL import REDUCED
from repro_torch.models.convert import stacked_params
from repro_torch.models.model import Model
from repro_torch.models.moe import moe_init

HERE = pathlib.Path(__file__).resolve().parent
ATTN_TOL = MOE_TOL = 1e-5
LOSS_RTOL = 2e-4
PARAM_REL = 1e-6
M_REL, NORM_REL = 1e-5, 1e-5
M_REL16, NORM_REL16 = 4e-3, 1e-4
SERVE_TOL = dict(rtol=2e-3, atol=2e-4)
PLAIN_REL, PLAIN_NORM_RTOL = 1e-6, 1e-6
DEADLINE_S = 300  # the ranks' and the JAX side's wall, well past their ~20 s


def _setup(rng) -> dict:
    """The inputs every side reads."""
    out = {}
    for seed, arch in enumerate(("yi-6b", "qwen2-moe-a2.7b")):
        cfg = REDUCED[arch]().replace(**P.F32)
        model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
        for k, v in stacked_params(model).items():
            out[f"{P.weights_key(arch, {})}.{k}"] = v.numpy()
    cfg = REDUCED["qwen2-moe-a2.7b"]().replace(**P.F32)
    for n, t in moe_init(torch.Generator().manual_seed(7), cfg).named_parameters():
        out[f"moe_layer.{n}"] = t.detach().numpy()
    out["moe_x"] = rng.standard_normal(P.MOE_X + (cfg.d_model,)).astype(np.float32)
    b, s = P.ATTN_BS
    for name, fields in P.ATTN_CASES.items():
        c = REDUCED["yi-6b"]().replace(**fields)
        for t, h in (("q", c.n_heads), ("k", c.n_kv_heads), ("v", c.n_kv_heads)):
            out[f"attn.{name}.{t}"] = rng.standard_normal((b, h, s, c.hd)).astype(np.float32)
    for name, (arch, _, b, s) in P.TRAIN_CASES.items():
        out[f"train.{name}.tokens"] = rng.integers(0, REDUCED[arch]().vocab, (b, s + 1))
    for name, (arch, _, b, s) in P.SERVE_CASES.items():
        out[f"serve.{name}.tokens"] = rng.integers(0, REDUCED[arch]().vocab, (b, s))
    return out


def _tree(flat, cfg):
    """The reference's parameter tree from the flat weights."""
    sds = jax.eval_shape(lambda: RModel(cfg).init(jax.random.PRNGKey(0)))
    paths = jax.tree_util.tree_flatten_with_path(sds)[0]
    leaves = [jnp.asarray(flat[".".join(str(k.key) for k in path)]) for path, _ in paths]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(sds), leaves)


def _flat(tree, prefix=""):
    return {prefix + ".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _per_shard(setup) -> dict:
    """The reference's single-device loss and optimizer, run per data
    shard, for every train case but ``JIT_TRAIN``'s: the loss and gradients averaged
    over the shard's microbatches, then over the shards (float32), then
    one optimizer update.  One compile per (architecture, gather dtype)."""
    out, fns, trees = {}, {}, {}
    for name, (arch, fields, b, _) in P.TRAIN_CASES.items():
        if name in P.JIT_TRAIN:
            continue
        # remat changes no value, and the chunked executor is the flash
        # path's to ~5e-7: both compile faster
        cfg = R_REDUCED[arch]().replace(**P.F32, **fields, remat="none",
                                        attention_impl="chunked")
        if arch not in trees:
            key = P.weights_key(arch, {}) + "."
            trees[arch] = _tree({k[len(key):]: v for k, v in setup.items()
                                 if k.startswith(key)}, cfg)
        params = trees[arch]
        fkey = (arch, cfg.gather_dtype)  # the mesh-less loss reads no mesh knob
        if fkey not in fns:
            model, gdt = RModel(cfg), jnp.dtype(cfg.gather_dtype)
            opt = RO.make_optimizer(cfg.optimizer, RO.warmup_cosine(3e-4, 2000, 100_000))

            def acc(state, p, t, model=model, gdt=gdt):
                pc = jax.tree_util.tree_map(lambda x: x.astype(gdt) if x.ndim >= 2 else x, p)
                loss, g = jax.value_and_grad(lambda q: model.loss(q, {"tokens": t})[0])(pc)
                total, grads = state
                return total + loss, jax.tree_util.tree_map(
                    lambda a, x: a + x.astype(jnp.float32), grads, g)

            def finish(state, n, p, opt=opt):
                total, grads = state
                new_p, new_o = opt.update(jax.tree_util.tree_map(lambda x: x / n, grads),
                                          opt.init(p), p, jnp.zeros((), jnp.int32))
                return total / n, new_p, new_o

            fns[fkey] = (jax.jit(acc), jax.jit(finish))
        acc, finish = fns[fkey]
        ndp = 2 if cfg.tp_size > 1 else 4
        nmb = cfg.microbatches_override or 1
        tokens = setup[f"train.{name}.tokens"]
        shards = np.split(tokens, ndp) if b % ndp == 0 else [tokens]
        state = (jnp.zeros((), jnp.float32),
                 jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, jnp.float32), params))
        for shard in shards:
            for mb in np.split(shard, nmb):
                state = acc(state, params, jnp.asarray(mb))
        loss, new_p, new_o = finish(state, float(len(shards) * nmb), params)
        out[f"train.{name}.loss"] = np.asarray(loss)
        out.update(_flat(new_p, f"train.{name}.p."))
        out.update(_flat(new_o, f"train.{name}.o."))
    return out


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_spmd")
    setup = _setup(np.random.default_rng(0))
    np.savez(tmp / "setup.npz", **setup)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", REPRO_AUTOTUNE_DISABLE="1",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    refs = [subprocess.Popen([sys.executable, str(HERE / "port_lm_jax.py"), str(tmp), part],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for part in ("forms", "serve")]
    ranks = mp.start_processes(P.run_rank, args=(str(tmp / "store"), str(tmp)),
                               nprocs=P.WORLD, join=False, start_method="spawn")
    try:
        shard_ref = _per_shard(setup)
        while not ranks.join(timeout=1):
            assert time.perf_counter() - t0 < DEADLINE_S, "the ranks did not finish"
        logs = [ref.communicate(timeout=DEADLINE_S)[0] for ref in refs]
    finally:
        for p in ranks.processes:
            if p.is_alive():
                p.kill()
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
    for ref, log in zip(refs, logs):
        assert ref.returncode == 0, log[-4000:]
    got = []
    for r in range(P.WORLD):
        with open(tmp / f"r{r}.json") as f:
            got.append((dict(np.load(tmp / f"r{r}.npz")), json.load(f)))
    want = dict(np.load(tmp / "jax_forms.npz"), **np.load(tmp / "jax_serve.npz"), **shard_ref)
    return setup, got, want, time.perf_counter() - t0


def _rows(facts, axes, b):
    """The row range a rank held of ``b`` rows split over ``axes`` of the
    (2, 2) mesh (all rows when they do not divide)."""
    idx, size = 0, 1
    for a in axes:
        idx, size = idx * 2 + facts["coords"][a], size * 2
    if b % size:
        return 0, b
    return idx * (b // size), (idx + 1) * (b // size)


def test_world_and_wall(sides):
    _, got, _, wall = sides
    assert [f["world"] for _, f in got] == [P.WORLD] * P.WORLD
    coords = sorted((f["coords"]["data"], f["coords"]["model"]) for _, f in got)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert wall < 120, wall


@pytest.mark.parametrize("name", list(P.MOE_CASES))
def test_moe_forms_match_the_reference_mesh(sides, name):
    _, got, want, _ = sides
    ref = want[f"moe.{name}.out"]
    for out, facts in got:
        lo, hi = _rows(facts, ("data",), ref.shape[0])
        np.testing.assert_allclose(out[f"moe.{name}.out"], ref[lo:hi], rtol=MOE_TOL,
                                   atol=MOE_TOL)
        np.testing.assert_array_equal(out[f"moe.{name}.aux"], want[f"moe.{name}.aux"])


@pytest.mark.parametrize("name", list(P.ATTN_CASES))
def test_attention_matches_the_reference_mesh(sides, name):
    _, got, want, _ = sides
    ref = want[f"attn.{name}"]
    axes = ("data", "model") if P.ATTN_CASES[name].get("tp_size", 16) <= 1 else ("data",)
    for out, facts in got:
        lo, hi = _rows(facts, axes, ref.shape[0])
        np.testing.assert_allclose(out[f"attn.{name}"], ref[lo:hi], rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


def _leaves(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.mark.parametrize("name", list(P.TRAIN_CASES))
def test_train_step(sides, name):
    _, got, want, _ = sides
    bf16 = P.TRAIN_CASES[name][1].get("gather_dtype") == "bfloat16"
    m_rel, norm_rel = (M_REL16, NORM_REL16) if bf16 else (M_REL, NORM_REL)
    for out, _ in got:  # every rank gathers the same step
        np.testing.assert_allclose(out[f"train.{name}.loss"], want[f"train.{name}.loss"],
                                   rtol=LOSS_RTOL)
        mine, ref = _leaves(out, f"train.{name}.p."), _leaves(want, f"train.{name}.p.")
        assert sorted(mine) == sorted(ref)
        for k, v in ref.items():
            assert np.abs(mine[k] - v).max() <= PARAM_REL * np.abs(v).max(), k
        mine, ref = _leaves(out, f"train.{name}.o."), _leaves(want, f"train.{name}.o.")
        assert sorted(mine) == sorted(ref)
        np.testing.assert_allclose(mine["gnorm"], ref["gnorm"], rtol=norm_rel)
        for k, v in ref.items():
            if k.startswith(("m.", "f.")):
                assert np.abs(mine[k] - v).max() <= m_rel * np.abs(v).max() + 1e-12, k


@pytest.mark.parametrize("name", P.PLAIN_UPDATE)
@pytest.mark.parametrize("clip", ["bundle", "none"])
def test_sharded_update_equals_the_gathered_one(sides, name, clip):
    """Each rank's new shards of the masters and the state against the
    gathered update's (gather, the mesh-less update, keep the shards) on
    the same weights and batch."""
    _, got, _, _ = sides
    adamw = P.TRAIN_CASES[name][1].get("optimizer", "adamw") == "adamw"
    for out, _ in got:
        mine, whole = out[f"train.{name}.plain.{clip}.gnorm"]
        np.testing.assert_allclose(mine, whole, rtol=PLAIN_NORM_RTOL)
        if clip == "none":
            assert whole < P.NO_CLIP  # the clip's scale is exactly 1
        else:
            assert whole > 1.0  # the bundle's clip, 1.0, scales the gradients
        if clip == "none" and adamw:
            assert bool(out[f"train.{name}.plain.{clip}.bits"])
        assert float(out[f"train.{name}.plain.{clip}.rel"]) <= PLAIN_REL


@pytest.mark.parametrize("name", list(P.TRAIN_CASES))
def test_update_allocates_no_whole_sharded_leaf(sides, name):
    """No tensor the update allocates on a rank has the shape of a whole
    sharded leaf, and none is larger than the rank's largest stacked leaf;
    the gathered update, on the whole leaves, does allocate them (the
    tracker sees them)."""
    _, got, _, _ = sides
    for out, _ in got:
        full, biggest, local = out[f"train.{name}.allocs"]
        assert full == 0 and 0 < biggest <= local, (full, biggest, local)
        if name in P.PLAIN_UPDATE:
            assert out[f"train.{name}.plain.control"][0] > 0


@pytest.mark.parametrize("name", list(P.TRAIN_CASES))
def test_train_step_gathers_in_gather_dtype(sides, name):
    """The shards are cast before the parameters' all-gather, so it moves
    ``gather_dtype`` bytes; the step hands back the DTensors it took."""
    _, got, _, _ = sides
    want = P.TRAIN_CASES[name][1].get("gather_dtype", "float32")
    for out, _ in got:
        assert list(out[f"train.{name}.gather_dtypes"]) == [want]
        assert bool(out[f"train.{name}.same_dtensors"])


@pytest.mark.parametrize("name", list(P.MEMORY_CASES) + list(P.MEMORY_MOE))
def test_train_step_gathers_a_unit_at_a_time(sides, name):
    """The parameters a rank's train step gathers, alive at once, stay
    within the leaves outside every unit plus two of the largest units;
    every float32 gradient of a whole unit leaf is freed before the next
    unit's gradients are cut; no expert is gathered over ``'model'``; with
    the bfloat16 gather under remat "none", autograd holds no float32 cast
    of a weight (at most the one an operation is using is alive).  The
    whole-gather ``loss_and_grads`` on the same shards exceeds the bound
    (deepened yi-6b; there the step's shard gradients are the blocks of its
    whole gradients within ``PLAIN_REL``) and gathers the experts whole
    (the MoE cases)."""
    _, got, _, _ = sides
    for out, _ in got:
        peak, bound, stale, followed, whole, cut, casts, control, control_whole = \
            out[f"mem.{name}"]
        assert 0 < peak <= bound, (peak, bound)
        bf16 = P.MEMORY_CASES.get(name, ("", {}))[1].get("gather_dtype") == "bfloat16"
        assert (0 < casts <= 1) if bf16 else casts == 0, casts
        assert stale == 0 and followed > 0, (stale, followed)
        assert whole == 0 and (cut > 0) == (name in P.MEMORY_MOE), (whole, cut)
        if name in P.MEMORY_MOE:
            assert control_whole > 0
        else:
            assert control > bound, (control, bound)
            # the shards' gradients are the whole ones' blocks
            loss_diff, rel = out[f"mem.{name}.grads"]
            assert loss_diff == 0 and rel <= PLAIN_REL, (loss_diff, rel)


@pytest.mark.parametrize("name", list(P.SERVE_CASES))
def test_serve_steps_match_the_reference_mesh(sides, name):
    """The bundle's prefill and decode steps against the reference's
    ``prefill_step_fn``/``serve_step_fn`` on the same (2, 2) mesh: per-shard
    MoE capacity, the EP form, the cache placements and the gather of the
    caches all inside."""
    _, got, want, _ = sides
    ref = want[f"serve.{name}"]
    for out, _ in got:  # every rank gathers the whole batch's logits
        mine = out[f"serve.{name}.got"]
        assert mine.shape == ref.shape
        np.testing.assert_allclose(mine, ref, **SERVE_TOL)
        assert (mine.argmax(-1) == ref.argmax(-1)).all()
        assert bool(out[f"serve.{name}.passed_through"])
        # each rank stores the caches the reference's stacked specs give it
        assert int(out[f"serve.{name}.cache_bytes"]) == int(want[f"serve.{name}.cache_bytes"])


@pytest.mark.parametrize("name", list(P.SERVE_CASES))
def test_serve_steps_match_the_meshless_path(sides, name):
    _, got, _, _ = sides
    for out, _ in got:
        lo, hi = out[f"serve.{name}.rows"]
        mine, ref = out[f"serve.{name}.got"][:, lo:hi], out[f"serve.{name}.want"]
        assert mine.shape[0] == P.DECODE_STEPS + 1
        np.testing.assert_allclose(mine, ref, **SERVE_TOL)
        assert (mine.argmax(-1) == ref.argmax(-1)).all()
        assert bool(out[f"serve.{name}.cache_is_dtensor"])


def test_every_shard_is_the_slice_its_spec_names(sides):
    _, got, _, _ = sides
    for _, facts in got:
        assert facts["errors"]["storage"] == []


@pytest.mark.parametrize("case", ["mesh_size", "production", "production_pods",
                                  "mesh_backend"])
def test_mesh_refusals(sides, case):
    _, got, _, _ = sides
    want = {"mesh_size": "need 6 ranks for a (2, 3) mesh", "production": "need 256 ranks",
            "production_pods": "need 512 ranks", "mesh_backend": "nccl"}[case]
    for _, facts in got:
        msg = facts["errors"][case]
        assert msg is not None and want in msg and ("group of 4" in msg or case ==
                                                    "mesh_backend"), msg
