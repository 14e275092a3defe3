"""The port's dry run (``launch/dryrun.py``) against the JAX package's.

* The bytes one rank stores of the parameters, the optimizer state and
  the caches, for every architecture at full width on the ``(16, 16)`` and
  ``(2, 16, 16)`` meshes, equal the reference's: the shard shapes of its
  ``param_specs``, ``opt_state_specs`` and ``cache_specs`` on its
  ``eval_shape`` trees, as its ``StepBundle`` builds them (no compile).
* One reduced cell a mode on a (2, 2) mesh, in a JAX subprocess of four
  host devices (``tests/port_dryrun_jax.py``): the reference's
  ``memory_analysis().argument_size_in_bytes`` equals the port's
  parameter, state and cache bytes plus the batch's (int32 tokens, as the
  reference feeds them), and its loop-aware ``analyze_hlo`` FLOPs times
  the four devices are within ``FLOP_REL`` of the port's.
* ``policy.on_card`` sends ``meta`` tensors to the plain versions, CPU
  ones too, CUDA ones to the kernel, and refuses any other device.
* The sharded update, reckoned on ``meta`` tensors: ``update_bytes``'
  shard terms fall with the mesh while its per-unit terms (the leaves
  outside every unit and two of the largest units, whole) do not, its
  totals for two cells, and one update's all-reduces, by axes.
* The command line records skips and failures and exits 1 on a failure,
  and a train cell's record holds ``update_bytes``.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec

import port_specs as S
import port_threads  # noqa: F401  (one torch thread a worker)

from repro.configs.base import SHAPES as R_SHAPES
from repro.distributed import sharding as RS
from repro.models.model import Model as RModel
from repro.optim import optimizer as RO
from repro_torch.configs.ALL import ARCH_IDS, REDUCED, config
from repro_torch.configs.base import SHAPES, ShapeCfg
from repro_torch.kernels.policy import on_card
from repro_torch.launch import dryrun as D
from repro_torch.launch.steps import StepBundle

HERE = pathlib.Path(__file__).resolve().parent
CELL = ("yi-6b", 32, 4)  # the reduced cell: (arch, seq, global batch)
# The reference counts the dots XLA emits on each device: its attention's
# at tile granularity (whole diagonal tiles of the chunked executor, and
# the flash custom VJP's backward) and no elementwise work; the port
# counts aten products and the flash forward's causal formula S(S+1)/2.
# Prefill differs most, the port counting 5.0 % fewer; train 0.07 % more,
# decode none.
FLOP_REL = 0.06
MODES = ("train", "prefill", "decode")


@pytest.fixture(autouse=True)
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_TORCH_BENCH_ARTIFACT", str(tmp_path / "absent.json"))


def _drop_fsdp(spec):
    """The reference's serve spec of resident weights (``launch/steps.py``)."""
    dims = []
    for ax in spec:
        axes = (ax,) if isinstance(ax, str) else (ax or ())
        if any(a in ("pod", "data") for a in axes):
            kept = tuple(a for a in axes if a not in ("pod", "data"))
            dims.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            dims.append(ax)
    return PartitionSpec(*dims)


def _stored(tree, specs, sizes) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    flat = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(flat)
    return sum(S._per_rank(x.shape, tuple(s), sizes) * jnp.dtype(x.dtype).itemsize
               for x, s in zip(leaves, flat))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's full-width parameter shapes."""
    return jax.eval_shape(lambda: RModel(S.ref_cfg(arch, True)).init(jax.random.PRNGKey(0)))


def _ref_bytes(arch, shape_name, mesh, sizes) -> dict:
    """The reference bundle's per-rank bytes, as its ``__init__`` places
    its trees."""
    cfg, shape = S.ref_cfg(arch, True), R_SHAPES[shape_name]
    params = _ref_params(arch)
    tp = cfg.tp_size > 1
    ep = bool(cfg.moe) and (cfg.moe_impl or cfg.moe.impl) == "ep"
    raw = RS.param_specs(params, mesh, tp, ep)
    pspecs = raw
    if shape.mode != "train" and cfg.weights_resident_serve:
        pspecs = jax.tree_util.tree_map(_drop_fsdp, raw,
                                        is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {"params": _stored(params, pspecs, sizes)}
    if shape.mode == "train":
        opt = RO.make_optimizer(cfg.optimizer, RO.warmup_cosine(3e-4, 2000, 100_000))
        state = jax.eval_shape(opt.init, params)
        out["opt_state"] = _stored(state, RS.opt_state_specs(state, raw, params, mesh), sizes)
    if shape.mode == "decode":
        cache = jax.eval_shape(lambda: RModel(cfg).init_cache(shape.global_batch,
                                                              shape.seq_len, jnp.bfloat16))
        out["caches"] = _stored(cache, RS.cache_specs(cache, mesh, tp), sizes)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_rank_bytes_equal_the_reference(arch):
    meshes = {"pod16x16": S.meshes()[1], "pod2x16x16": S.meshes()[2]}
    for name, (mesh, sizes) in meshes.items():
        assert sizes == D.MESHES[name]
        for shape_name in ("train_4k", "decode_32k"):  # serve specs: decode's
            mine = D.rank_bytes(StepBundle(config(arch), sizes, SHAPES[shape_name]))
            assert mine == _ref_bytes(arch, shape_name, mesh, sizes), (name, shape_name)


@pytest.fixture(scope="module", autouse=True)
def reference_cell():
    """The JAX side, started with the module's first test so that its
    compiles run beside the tests before it; ``get()`` waits for it."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, str(HERE / "port_dryrun_jax.py"),
                             *map(str, CELL)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    seen = {}

    def get():
        if not seen:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
            seen.update(json.loads(out.strip().splitlines()[-1]))
        return seen

    try:
        yield get
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("mode", MODES)
def test_reduced_cell_against_the_reference_compile(reference_cell, mode):
    arch, seq, batch = CELL
    cfg = REDUCED[arch]().replace(act_dtype="float32", param_dtype="float32")
    sizes = {"data": 2, "model": 2}
    bundle = StepBundle(cfg, sizes, ShapeCfg("c", seq, batch, mode))
    inputs = sum(S._per_rank(shape, tuple(bundle.bspecs[k]), sizes) * 4
                 for k, shape in bundle.batch_shapes.items())
    want = reference_cell()[mode]
    assert sum(D.rank_bytes(bundle).values()) + inputs == want["argument_size"]
    flops, _ = D.step_flops(cfg, bundle.shape)
    ref = want["flops_per_device"] * 4
    assert abs(sum(flops.values()) - ref) <= FLOP_REL * ref, (flops, ref)


@pytest.mark.parametrize("gather", ["float32", "bfloat16"])
def test_update_bytes_shard_terms_fall_with_the_mesh(gather):
    """yi-6b in full to train: the sharded update's whole terms (the
    parameters gathered a unit at a time, their full gradients: the
    embedding, unembedding and final norm, and two layers) are the same on
    (1, 1) and (2, 2); each shard term (masters, gradients, state) falls
    as 1/k, k the ranks each leaf's spec cuts it into, so near a quarter,
    the embedding and unembedding (cut over ``'model'`` only) a half."""
    cfg = config("yi-6b").replace(gather_dtype=gather)
    one, four = (StepBundle(cfg, sizes, SHAPES["train_4k"])
                 for sizes in ({"data": 1, "model": 1}, {"data": 2, "model": 2}))
    u1, u4 = D.update_bytes(one), D.update_bytes(four)
    stored = D.rank_bytes(four)
    assert (u4["masters"], u4["state"]) == (stored["params"], stored["opt_state"])
    meta = dict(one.model.named_parameters())
    n = sum(p.numel() for p in meta.values())
    assert u1["masters"] == u1["grads"] == 4 * n
    outer = sum(meta[m].numel() for m in ("embed.e", "unembed", "final_norm.w"))
    layer = sum(t.numel() for m, t in meta.items() if m.startswith("stack.0."))
    assert sorted(one.outer) == ["embed.e", "final_norm.w", "unembed"]
    assert len(one.units) == cfg.n_layers
    whole = outer + 2 * layer  # the leaves outside every unit and two layers
    assert u1["full_grads"] == u4["full_grads"] == 4 * whole < 4 * n / 5
    assert u1["gathered"] == u4["gathered"]
    if gather == "bfloat16":  # every leaf but the final norm moves 2 bytes
        assert 2 * whole < u4["gathered"] < 2 * whole + 4 * cfg.d_model
    else:
        assert u4["gathered"] == 4 * whole
    # every axis of the (2, 2) mesh has two ranks
    k = {name: 2 ** sum(len((e,) if isinstance(e, str) else e or ()) for e in spec)
         for name, spec in four.pspecs.items()}
    meta = dict(four.model.named_parameters())
    assert u4["masters"] == u4["grads"] == sum(4 * t.numel() // k[m] for m, t in meta.items())
    for term in ("masters", "grads", "state"):
        assert u1[term] / 4 <= u4[term] <= 0.28 * u1[term], term
    assert u4["state"] == 2 * u4["masters"] + 4  # AdamW's m and v, and the norm


# What a rank holds for the sharded update in GB (``update_bytes`` summed),
# a unit at a time; gathering every leaf whole, it held 74.8 and 5,398.
UPDATE_GB = {("yi-6b", 2): 33.31, ("deepseek-v3-671b", 16): 53.84}


@pytest.mark.parametrize("arch,k", sorted(UPDATE_GB))
def test_update_bytes_of_a_unit_at_a_time(arch, k):
    """The train step's reckoning for yi-6b on (2, 2) and deepseek-v3 on
    (16, 16): the shards, the leaves outside every unit and two of the
    largest units whole, deepseek's experts after their ``'model'`` cut
    (the EP and TP forms take them as this rank's block)."""
    bundle = StepBundle(config(arch), {"data": k, "model": k}, SHAPES["train_4k"])
    total = sum(D.update_bytes(bundle).values())
    assert round(total / 1e9, 2) == UPDATE_GB[arch, k]
    assert bundle.blocks == (arch == "deepseek-v3-671b")
    outer, unit = D.unit_bytes(bundle)
    if bundle.blocks:  # an expert leaf is 1/16 of itself in the largest unit
        whole = StepBundle(config(arch).replace(tp_size=1), {"data": k, "model": k},
                           SHAPES["train_4k"])
        assert unit < D.unit_bytes(whole)[1] / 8


# The all-reduces one sharded update issues on the (16, 16) mesh, by the
# axes each sums over: AdamW's global norm, one for each set of axes that
# cuts a leaf; Adafactor's also a period of each matrix leaf (its row and
# column means, then the rows' mean of those) and the RMS of each leaf.
UPDATE_ALL_REDUCES = {
    "yi-6b": {("model",): 1, ("data", "model"): 1},
    "internlm2-20b": {("data",): 576, ("model",): 438, ("data", "model"): 8},
}


@pytest.mark.parametrize("arch", sorted(UPDATE_ALL_REDUCES))
def test_sharded_update_all_reduces(arch, monkeypatch):
    """One update on a rank's ``meta`` shards of the model in full, the
    partial sums through ``StepBundle._sums``: the all-reduces it issues,
    and none on a mesh of one rank, where every leaf is whole."""
    import collections

    from repro_torch.distributed.sharding import local_shape
    from repro_torch.launch import steps

    calls = []
    monkeypatch.setattr(steps, "all_reduce", lambda x, mesh, axes: calls.append(tuple(axes)) or x)
    counts = []
    for sizes in ({"data": 16, "model": 16}, {"data": 1, "model": 1}):
        bundle = StepBundle(config(arch), sizes, SHAPES["train_4k"])
        params = {n: torch.empty(local_shape(tuple(t.shape), bundle.pspecs[n], sizes),
                                 device="meta")
                  for n, t in bundle.model.named_parameters()}
        grads = {n: torch.empty_like(t) for n, t in params.items()}
        calls.clear()
        bundle.opt.update(grads, bundle.opt.init(params), params, 0, sums=bundle._sums)
        counts.append(dict(collections.Counter(calls)))
    assert counts == [UPDATE_ALL_REDUCES[arch], {}]


def test_on_card_routes_meta_to_the_plain_version():
    assert on_card(torch.empty(2, device="meta"), "t") is False
    assert on_card(torch.empty(2), "t") is False
    assert on_card(types.SimpleNamespace(device=torch.device("cuda", 0)), "t") is True
    with pytest.raises(ValueError, match="no kernel for tensors on"):
        on_card(types.SimpleNamespace(device=torch.device("xpu")), "t")


def test_command_line_records_skips_and_failures(tmp_path):
    out = str(tmp_path)
    assert D.main(["--arch", "yi-6b", "--shape", "long_500k", "--outdir", out]) == 0
    rec = json.loads((tmp_path / "pod16x16" / "yi-6b__long_500k.json").read_text())
    assert rec["status"] == "skip" and "sub-quadratic" in rec["reason"]
    assert D.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--multi-pod",
                   "--outdir", out]) == 0
    rec = json.loads((tmp_path / "pod2x16x16" / "xlstm-350m__decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 512 and rec["flops"] > 0
    assert set(rec["bytes_per_rank"]) == {"params", "caches"}
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert D.main(["--arch", "yi-6b", "--shape", "decode_32k", "--set", "n_heads=7",
                   "--outdir", out]) == 1
    rec = json.loads((tmp_path / "pod16x16" / "yi-6b__decode_32k__n_heads=7.json").read_text())
    assert rec["status"] == "error" and rec["error"]


def test_command_line_records_the_update_bytes(tmp_path):
    """A train cell's record breaks the sharded update's bytes down by
    term, its shards those that ``bytes_per_rank`` stores."""
    assert D.main(["--arch", "yi-6b", "--shape", "train_4k", "--set", "n_layers=2",
                   "--outdir", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "pod16x16" / "yi-6b__train_4k__n_layers=2.json").read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert set(rec["update_bytes"]) == {"gathered", "full_grads", "masters", "grads", "state"}
    assert set(rec["bytes_per_rank"]) == {"params", "opt_state"}
    assert rec["update_bytes"]["masters"] == rec["bytes_per_rank"]["params"]
    assert rec["update_bytes"]["state"] == rec["bytes_per_rank"]["opt_state"]
