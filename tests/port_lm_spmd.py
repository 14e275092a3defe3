"""The rank program of ``tests/test_torch_lm_spmd.py``: one rank of a
4-rank gloo group runs the port's LM mesh forms and step bundle on the
inputs the test wrote (``setup.npz``) and saves what it saw.

Spawned processes import this module by name, so it stays importable
from ``tests/`` and imports neither JAX nor the JAX package; torch is
imported inside ``run_rank``.  The case tables are shared with the JAX
side (``tests/port_lm_jax.py``) and the test.
"""

import datetime
import json
import os

import numpy as np

WORLD = 4
MESH = ((2, 2), ("data", "model"))
F32 = dict(act_dtype="float32", param_dtype="float32")

# MoE forms on reduced qwen2-moe-a2.7b: x (B, S, d).
MOE_X = (4, 16)
MOE_CASES = {"tp": {}, "ep": {"moe_impl": "ep"}}

# Attention: (B, S) of q, k, v on reduced yi-6b with the fields replaced.
ATTN_BS = (4, 64)
ATTN_CASES = {
    "tp": {},  # Hq 4, Hkv 1: 2 heads a rank, one KV head
    "unaligned": {"d_model": 96, "n_heads": 6, "n_kv_heads": 3},  # 3 heads a rank, groups of 2
    "tp1": {"tp_size": 1},  # rows over every axis
}

# Train steps: (arch, fields, global batch, seq).  The JIT_TRAIN cases are
# held against the reference's ``jit_train`` on the (2, 2) mesh, the others
# against its single-device loss and optimizer run per data shard.
TRAIN_CASES = {
    "yi": ("yi-6b", {}, 4, 32),
    "yi_af": ("yi-6b", {"optimizer": "adafactor"}, 4, 32),
    "yi_tp1": ("yi-6b", {"tp_size": 1}, 8, 32),
    "yi_mb2": ("yi-6b", {"microbatches_override": 2}, 8, 32),
    "yi_bf16": ("yi-6b", {"gather_dtype": "bfloat16"}, 4, 32),
    "yi_rep": ("yi-6b", {"tp_size": 1}, 2, 32),  # 2 rows on 4 data ranks: replicated
    "moe_tp": ("qwen2-moe-a2.7b", {}, 4, 32),
    "moe_ep": ("qwen2-moe-a2.7b", {"moe_impl": "ep"}, 4, 32),
}
JIT_TRAIN = ("yi", "yi_af")
# The cases whose sharded update is also held against the gathered one (a
# plain version in the rank program: gather, the mesh-less update, keep the
# shards), with the bundle's clip and with a clip no norm reaches.
PLAIN_UPDATE = ("yi", "yi_af")
NO_CLIP = 1e9

# The gathered parameters a train step holds at once (``_LiveGathers``):
# reduced yi-6b deepened to 8 layers, remat "none" and "full", on weights
# from MEMORY_SEED and a batch of 4 x 32, each step beside the whole-gather
# ``loss_and_grads`` (its gradients too); the MoE train cases are counted
# as they run.
MEMORY_CASES = {"yi8": ("yi-6b", {"n_layers": 8, "remat": "none"}),
                "yi8_full": ("yi-6b", {"n_layers": 8, "remat": "full"}),
                "yi8_bf16": ("yi-6b", {"n_layers": 8, "remat": "none",
                                       "gather_dtype": "bfloat16"})}
MEMORY_MOE = ("moe_tp", "moe_ep")
MEMORY_SEED = 11

# Serving: (arch, fields, batch, prompt) prefilled and decoded DECODE_STEPS
# tokens through the bundle.
SERVE_CASES = {
    "yi": ("yi-6b", {}, 4, 32),
    "yi_b1": ("yi-6b", {}, 1, 32),  # one row on (2, 2): the 2 periods go over data, the row not
    "moe_ep": ("qwen2-moe-a2.7b", {"moe_impl": "ep"}, 4, 32),
}
DECODE_STEPS = 2

# Storage: bundles whose every stored shard is held against numpy slicing
# on the (2, 2, 1) pod/data/model mesh.
STORE_MESH = ((2, 2, 1), ("pod", "data", "model"))
STORE_CASES = {
    "yi_train": ("yi-6b", {}, "train"),
    "moe_ep_train": ("qwen2-moe-a2.7b", {"moe_impl": "ep"}, "train"),
    "yi_decode": ("yi-6b", {}, "decode"),
}


def weights_key(arch: str, fields: dict) -> str:
    """The setup's weight prefix of a config (weights depend on widths)."""
    wide = {k: v for k, v in fields.items() if k in ("d_model", "n_heads", "n_kv_heads")}
    return arch + "".join(f"-{k}{v}" for k, v in sorted(wide.items()))


def numpy_slice(full: np.ndarray, spec, sizes: dict, coords: dict) -> np.ndarray:
    """The block of ``full`` that ``spec`` gives the rank at ``coords``:
    a dim over several axes is cut pod-major, as JAX cuts it."""
    out = full
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx, size = 0, 1
        for a in axes:
            idx, size = idx * sizes[a] + coords[a], size * sizes[a]
        n = full.shape[d] // size
        out = np.take(out, np.arange(idx * n, (idx + 1) * n), axis=d)
    return out


def _cfg(arch, fields):
    from repro_torch.configs.ALL import REDUCED

    return REDUCED[arch]().replace(**F32, **fields)


def _model(setup, arch, fields):
    import torch

    from repro_torch.models.convert import load_stacked
    from repro_torch.models.model import Model

    key = weights_key(arch, fields) + "."
    flat = {k[len(key):]: v for k, v in setup.items() if k.startswith(key)}
    model = Model(_cfg(arch, fields), device="cpu")
    load_stacked(model, flat)
    return model.requires_grad_(False), torch


def _rows_of(mesh, axes, b):
    """This rank's row range of a batch of ``b`` rows split over ``axes``."""
    from repro_torch.distributed.collectives import axis_coords, axis_sizes

    sizes, coords = axis_sizes(mesh), axis_coords(mesh)
    idx, size = 0, 1
    for a in axes:
        idx, size = idx * sizes[a] + coords[a], size * sizes[a]
    if b % size:
        return 0, b
    n = b // size
    return idx * n, (idx + 1) * n


def _moe(setup, mesh, out):
    import torch

    from repro_torch.models.moe import MoE, moe_apply

    for name, fields in MOE_CASES.items():
        cfg = _cfg("qwen2-moe-a2.7b", fields)
        p = MoE(cfg, torch.float32, "cpu")
        with torch.no_grad():
            for n, t in p.named_parameters():
                t.copy_(torch.from_numpy(setup[f"moe_layer.{n}"]))
        x = torch.from_numpy(setup["moe_x"])
        lo, hi = _rows_of(mesh, ("data",), x.shape[0])
        with torch.no_grad():
            o, aux = moe_apply(p, cfg, x[lo:hi], mesh)
        out[f"moe.{name}.out"] = o.numpy()
        out[f"moe.{name}.aux"] = aux.numpy()


def _attention(setup, mesh, out):
    import torch

    from repro_torch.models.attention import sharded_causal_attention

    for name, fields in ATTN_CASES.items():
        cfg = _cfg("yi-6b", fields)
        q, k, v = (torch.from_numpy(setup[f"attn.{name}.{t}"]) for t in "qkv")
        axes = ("data",) if cfg.tp_size > 1 else ("data", "model")
        lo, hi = _rows_of(mesh, axes, q.shape[0])
        with torch.no_grad():
            o = sharded_causal_attention(q[lo:hi], k[lo:hi], v[lo:hi], cfg, mesh)
        out[f"attn.{name}"] = o.numpy()


def _gathered(bundle, tree, specs):
    """Every leaf of a DTensor tree gathered to a numpy array."""
    from repro_torch.distributed.sharding import Spec, gather_tensor

    if isinstance(specs, Spec):
        return gather_tensor(tree, bundle.mesh, specs).numpy()
    return {k: _gathered(bundle, tree[k], v) for k, v in specs.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _train(setup, mesh, out):
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.steps import build
    from repro_torch.models.convert import stacked_groups

    for name, (arch, fields, b, s) in TRAIN_CASES.items():
        model, _ = _model(setup, arch, fields)
        bundle = build(model.cfg, mesh, ShapeCfg("t", s, b, "train"))
        tokens = torch.from_numpy(setup[f"train.{name}.tokens"])
        if name in PLAIN_UPDATE:
            _plain_update(setup, mesh, name, out)
        params = bundle.shard_params(model)
        opt_state = bundle.init_opt_state(params)
        batch = bundle.shard_batch({"tokens": tokens})
        with _GatherDtypes() as gathered, _tracked_update(bundle) as allocs, \
                _LiveGathers(bundle) as live:
            new_p, new_o, step, metrics = bundle.train_step(params, opt_state, 0, batch)
        assert step == 1
        if name in MEMORY_MOE:
            with _LiveGathers(bundle) as whole:
                bundle.loss_and_grads(params, batch)
            out[f"mem.{name}"] = live.facts(whole)
        out[f"train.{name}.same_dtensors"] = np.array(
            all(new_p[n] is params[n] for n in params) and new_o is opt_state)
        out[f"train.{name}.gather_dtypes"] = np.array(sorted(set(gathered)))
        out[f"train.{name}.allocs"] = _alloc_facts(bundle, allocs)
        out[f"train.{name}.loss"] = metrics["loss"].numpy()
        full = _gathered(bundle, new_p, bundle.pspecs)
        for key, members in stacked_groups(full).items():
            arr = [full[m] for m in members]
            out[f"train.{name}.p.{key}"] = np.stack(arr) if key.startswith("stack.") else arr[0]
        for k, v in _flat(_gathered(bundle, new_o, bundle.ospecs)).items():
            out[f"train.{name}.o.{k}"] = v


def _memory(mesh, out):
    """``MEMORY_CASES``: one train step and one whole-gather
    ``loss_and_grads`` on the same shards, each counted by
    ``_LiveGathers``; the step's shard gradients (``_grads``) against the
    whole ones' blocks, ``mem.<case>.grads`` ``[|loss diff|, the largest
    |diff| / max|leaf|]``."""
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.distributed.sharding import local_block
    from repro_torch.launch.steps import build
    from repro_torch.models.model import Model

    for name, (arch, fields) in MEMORY_CASES.items():
        cfg = _cfg(arch, fields)
        model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(MEMORY_SEED))
        bundle = build(cfg, mesh, ShapeCfg("m", 32, 4, "train"))
        tokens = torch.randint(0, cfg.vocab, (4, 33), generator=torch.Generator().manual_seed(0))
        params = bundle.shard_params(model)
        batch = bundle.shard_batch({"tokens": tokens})
        with _LiveGathers(bundle) as whole:
            loss, grads = bundle.loss_and_grads(params, batch)
        mine_loss, mine = bundle._grads(params, batch)
        rel = max(float((mine[n] - local_block(g, mesh, bundle.pspecs[n])).abs().max())
                  / (float(g.abs().max()) or 1.0) for n, g in grads.items())
        out[f"mem.{name}.grads"] = np.array([abs(float(mine_loss - loss)), rel])
        with _LiveGathers(bundle) as live:
            bundle.train_step(params, bundle.init_opt_state(), 0, batch)
        out[f"mem.{name}"] = live.facts(whole)


class _LiveGathers:
    """What a bundle's parameter gathers hold inside the block.

    Each tensor ``bundle._gather_leaf`` returns in a storage of its own (a
    copy the gather or its cast made, not the shard itself) counts its
    bytes from its return until a finalizer on its storage runs; ``peak``
    is the most alive at once.  An expert leaf of ``bundle.split`` counts
    as gathered whole over ``'model'`` (``whole``) or cut there (``cut``).
    ``casts`` is the most ``Tensor.to`` copies of gathered parameters (a
    bfloat16 weight cast for float32 activations) alive at once, each
    followed to its storage's finalizer.  At each leaf's gradient cut (``_leaf_grad``) a float32 gradient of a
    whole unit leaf that the cut shrinks is followed to its storage's
    finalizer (``followed``); ``stale`` counts the cuts of a unit's leaf
    that began while one of another unit was still alive."""

    def __init__(self, bundle):
        self.b = bundle
        self.live = self.peak = self.whole = self.cut = self.followed = self.stale = 0
        self.cast_live = self.casts = 0

    def __enter__(self):
        import math
        import weakref

        from repro_torch.distributed.sharding import local_shape
        from repro_torch.launch import steps
        from repro_torch.models.model import unit_of

        b = self.b
        gather, leaf_grad, note = b._gather_leaf, b._leaf_grad, steps._Step.cast
        numel = {n: t.numel() for n, t in b.model.named_parameters()}
        alive = {}

        def drop(n):
            self.live -= n

        def uncast():
            self.cast_live -= 1

        def cast(step, src, out, args, kwargs):
            if step._entry(src) is not None:
                self.cast_live += 1
                self.casts = max(self.casts, self.cast_live)
                weakref.finalize(out.untyped_storage(), uncast)
            return note(step, src, out, args, kwargs)

        def counted(shard, name, spec=None):
            out = gather(shard, name, spec)
            storage = out.untyped_storage()
            if storage.data_ptr() != shard.untyped_storage().data_ptr():
                self.live += storage.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(storage, drop, storage.nbytes())
            if name in b.split:
                if out.numel() == numel[name]:
                    self.whole += 1
                else:
                    self.cut += 1
            return out

        def cut(g, name):
            unit = unit_of(name)
            self.stale += unit is not None and any(u != unit for u in alive.values())
            if unit is not None and math.prod(local_shape(g.shape, b.gspecs[name],
                                                          b.mesh)) < g.numel():
                key = object()
                alive[key] = unit
                weakref.finalize(g.untyped_storage(), alive.pop, key, None)
                self.followed += 1
            return leaf_grad(g, name)

        b._gather_leaf, b._leaf_grad, steps._Step.cast = counted, cut, cast
        self.note = note
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import steps

        del self.b._gather_leaf, self.b._leaf_grad
        steps._Step.cast = self.note
        return False

    def facts(self, whole: "_LiveGathers"):
        """``[peak, bound, stale, followed, whole, cut, casts]`` of the train
        step, then the whole-gather control's ``peak`` and ``whole``: ``bound``
        is the leaves outside every unit plus two of the largest units, as
        the dry run reckons them (``launch/dryrun.unit_bytes``)."""
        from repro_torch.launch.dryrun import unit_bytes

        outer, unit = unit_bytes(self.b)
        return np.array([self.peak, outer + 2 * unit, self.stale, self.followed, self.whole,
                         self.cut, self.casts, whole.peak, whole.whole])


def _plain_update(setup, mesh, name, out):
    """The gathered update against the sharded one on the same weights and
    batch: the masters, the state and the reduced gradients gathered whole
    (``loss_and_grads``), the mesh-less update, this rank's shards kept.
    Once with the bundle's clip and once with ``NO_CLIP``, where the clip's
    scale is exactly 1: ``plain.<clip>.bits`` whether every shard is the
    same bits, ``plain.<clip>.rel`` the largest ``|diff| / max|leaf|`` of a
    parameter or state leaf, ``plain.<clip>.gnorm`` both norms.  The plain
    update allocates the full leaves (``plain.control``), which the tracker
    sees."""
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.distributed.sharding import gather_tensor, local_block
    from repro_torch.launch.steps import _with_specs, build
    from repro_torch.optim.optimizer import make_optimizer, warmup_cosine

    arch, fields, b, s = TRAIN_CASES[name]
    tokens = torch.from_numpy(setup[f"train.{name}.tokens"])
    for clip in ("bundle", "none"):
        model, _ = _model(setup, arch, fields)
        bundle = build(model.cfg, mesh, ShapeCfg("t", s, b, "train"))
        if clip == "none":
            bundle.opt = make_optimizer(model.cfg.optimizer, warmup_cosine(3e-4, 2000, 100_000),
                                        grad_clip=NO_CLIP)
        params = bundle.shard_params(model)
        batch = bundle.shard_batch({"tokens": tokens})
        masters = {n: t.clone() for n, t in bundle.gather_params(params).items()}
        state = bundle.init_opt_state()
        whole = _with_specs(lambda dt, spec: gather_tensor(dt, mesh, spec).clone(), state,
                            bundle.ospecs)
        _, grads = bundle.loss_and_grads(params, batch)
        with _tracked_update(bundle) as allocs:
            bundle.opt.update(grads, whole, masters, 0)
        if clip == "bundle":
            out[f"train.{name}.plain.control"] = _alloc_facts(bundle, allocs)
        params, state, _, _ = bundle.train_step(params, state, 0, batch)
        pairs = [(params[n].to_local(), masters[n], bundle.pspecs[n]) for n in masters]
        pairs += _with_pairs(state, whole, bundle.ospecs)
        bits, rel = True, 0.0
        for mine, want, spec in pairs:
            block = local_block(want, mesh, spec)
            bits &= torch.equal(mine, block)
            scale = float(want.abs().max()) or 1.0
            rel = max(rel, float((mine - block).abs().max()) / scale)
        out[f"train.{name}.plain.{clip}.bits"] = np.array(bits)
        out[f"train.{name}.plain.{clip}.rel"] = np.array(rel)
        out[f"train.{name}.plain.{clip}.gnorm"] = np.array(
            [float(state["gnorm"].to_local()), float(whole["gnorm"])])


def _with_pairs(tree, whole, specs):
    """``(this rank's block, the whole leaf, spec)`` of every state leaf."""
    if not isinstance(specs, dict):  # a Spec
        return [(tree.to_local(), whole, specs)]
    return [p for k in specs for p in _with_pairs(tree[k], whole[k], specs[k])]


class _GatherDtypes:
    """The dtype of every tensor the bundle's parameter gathers hand to
    ``torch.distributed.all_gather`` inside the block."""

    def __enter__(self):
        import torch.distributed as dist

        from repro_torch.launch import steps

        self.seen, self.inside = [], False
        self.real = (steps.gather_tensor, dist.all_gather)

        def gather_tensor(*a, **kw):
            self.inside = True
            try:
                return self.real[0](*a, **kw)
            finally:
                self.inside = False

        def all_gather(parts, x, *a, **kw):
            if self.inside:
                self.seen.append(str(x.dtype).replace("torch.", ""))
            return self.real[1](parts, x, *a, **kw)

        steps.gather_tensor, dist.all_gather = gather_tensor, all_gather
        return self.seen

    def __exit__(self, *exc):
        import torch.distributed as dist

        from repro_torch.launch import steps

        steps.gather_tensor, dist.all_gather = self.real
        return False


class _tracked_update:
    """The shape and bytes of every tensor ``bundle.opt.update`` allocates
    inside the block (an op's output whose storage none of its inputs
    holds), recorded by a dispatch mode around the update alone."""

    def __init__(self, bundle):
        self.bundle, self.allocs = bundle, []

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        from repro_torch.optim.optimizer import Optimizer

        allocs = self.allocs

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                result = func(*args, **(kwargs or {}))
                held = {t.untyped_storage().data_ptr()
                        for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)}
                for t in tree_flatten(result)[0]:
                    if (isinstance(t, torch.Tensor)
                            and t.untyped_storage().data_ptr() not in held):
                        allocs.append((tuple(t.shape), t.untyped_storage().nbytes()))
                return result

        opt = self.real = self.bundle.opt

        def update(*a, **kw):
            with Mode():
                return opt.update(*a, **kw)

        self.bundle.opt = Optimizer(opt.init, update)
        return allocs

    def __exit__(self, *exc):
        self.bundle.opt = self.real
        return False


def _alloc_facts(bundle, allocs):
    """``[full, biggest, local]``: how many allocations are shaped as a
    whole sharded leaf (a per-period tensor or a stacked leaf, parameter or
    state; a shape that is also a leaf's block on this rank, such as a
    replicated stack of norm weights beside a factored statistic, is not
    counted), the largest allocation's bytes, and the largest stacked
    parameter leaf's float32 bytes on this rank."""
    from repro_torch.distributed.collectives import axis_sizes
    from repro_torch.distributed.sharding import _axes, _stacked_specs, local_shape
    from repro_torch.launch.steps import _with_specs

    sizes = axis_sizes(bundle.mesh)
    whole, blocks = set(), set()

    def leaf(shape, spec):
        block = local_shape(shape, spec, sizes)
        blocks.add(block)
        if any(sizes[a] > 1 for e in spec for a in _axes(e)):
            whole.add(tuple(shape))
        return 4 * int(np.prod(block))

    shapes = {n: tuple(t.shape) for n, t in bundle.model.named_parameters()}
    for n, shape in shapes.items():
        leaf(shape, bundle.pspecs[n])
    local = [leaf(shape, spec) for shape, spec in _stacked_specs(bundle.pspecs, shapes).values()]
    _with_specs(leaf, bundle.opt_shapes, bundle.ospecs)
    full = sum(shape in whole - blocks for shape, _ in allocs)
    return np.array([full, max((n for _, n in allocs), default=0), max(local)])


def _serve(setup, mesh, out):
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.steps import build
    from repro_torch.distributed.sharding import map_specs

    for name, (arch, fields, b, s) in SERVE_CASES.items():
        model, _ = _model(setup, arch, fields)
        bundle = build(model.cfg, mesh, ShapeCfg("d", s, b, "decode"))
        params = bundle.shard_params(model)
        prompts = torch.from_numpy(setup[f"serve.{name}.tokens"])
        logits, caches = bundle.prefill_step(params, bundle.shard_batch({"tokens": prompts}))
        got = [logits.full_tensor().numpy()]
        tok = torch.from_numpy(got[0][:, -1].argmax(-1))[:, None]
        passed = True
        for i in range(DECODE_STEPS):
            step = {"tokens": tok, "pos": torch.full((b,), s + i, dtype=torch.long)}
            logits, new = bundle.serve_step(params, caches, bundle.shard_batch(step))
            got.append(logits.full_tensor().numpy())
            tok = torch.from_numpy(got[-1][:, -1].argmax(-1))[:, None]
            # the prefill's keys and values come back as the caller's DTensors
            for blk, nblk in zip(caches["stack"].values(), new["stack"].values()):
                passed &= all(c is n for c, n in zip(blk["mixer"], nblk["mixer"]))
        out[f"serve.{name}.got"] = np.stack(got)
        out[f"serve.{name}.passed_through"] = np.array(passed)
        # the bytes this rank stores, and its stacked blocks' shapes
        resident = []
        map_specs(lambda _, t: resident.append(t.to_local().nbytes), caches)
        out[f"serve.{name}.cache_bytes"] = np.array(sum(resident))
        # the mesh-less path on the same weights: each data shard's rows
        # alone (MoE capacity is per shard), the same tokens fed back
        lo, hi = _rows_of(mesh, bundle.dp, b) if bundle.rows_split else (0, b)
        ref_logits, ref_caches = model.prefill({"tokens": prompts[lo:hi]})
        want = [ref_logits.numpy()]
        feed = torch.from_numpy(got[0][lo:hi, -1].argmax(-1))[:, None]
        for i in range(DECODE_STEPS):
            step = {"tokens": feed, "pos": torch.full((hi - lo,), s + i, dtype=torch.long)}
            ref_logits, _ = model.decode(ref_caches, step)
            want.append(ref_logits.numpy())
            feed = torch.from_numpy(got[i + 1][lo:hi, -1].argmax(-1))[:, None]
        out[f"serve.{name}.want"] = np.stack(want)
        out[f"serve.{name}.rows"] = np.array([lo, hi])
        kinds = set()
        map_specs(lambda _, t: kinds.add(type(t).__name__), caches)
        out[f"serve.{name}.cache_is_dtensor"] = np.array(kinds == {"DTensor"})


def _storage(setup, errors):
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.distributed.collectives import axis_coords, axis_sizes
    from repro_torch.distributed.sharding import named
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build

    mesh = make_mesh(*STORE_MESH, device="cpu")
    sizes, coords = axis_sizes(mesh), axis_coords(mesh)
    bad = []
    for name, (arch, fields, mode) in STORE_CASES.items():
        model, _ = _model(setup, arch, fields)
        bundle = build(model.cfg, mesh, ShapeCfg("s", 32, 4, mode))
        params = bundle.shard_params(model)
        for n, t in model.named_parameters():
            spec = bundle.pspecs[n]
            got = params[n].to_local().numpy()
            if not np.array_equal(got, numpy_slice(t.numpy(), spec, sizes, coords)):
                bad.append(f"{name} {n} {spec}")
            dtensor = distribute_tensor(t, mesh, named(mesh, spec), src_data_rank=None)
            if not torch.equal(dtensor.to_local(), params[n].to_local()):
                bad.append(f"{name} {n} {spec}: distribute_tensor cuts another block")
        if mode == "train":
            state = bundle.init_opt_state()
            for k, v in _flat(state).items():
                if tuple(v.to_local().shape) != numpy_slice(
                        np.zeros(v.shape), _leaf(bundle.ospecs, k), sizes, coords).shape:
                    bad.append(f"{name} opt {k}")
        tokens = torch.arange(4 * 33).reshape(4, 33)
        local = bundle.shard_batch({"tokens": tokens})["tokens"].to_local().numpy()
        if not np.array_equal(local, numpy_slice(tokens.numpy(), bundle.bspecs["tokens"],
                                                 sizes, coords)):
            bad.append(f"{name} batch")
    errors["storage"] = bad


def _leaf(tree, dotted):
    """A leaf of a tree whose dict keys may hold dots, by its dotted path."""
    if not isinstance(tree, dict):
        return tree
    for k, v in tree.items():
        if dotted == k:
            return v
        if dotted.startswith(k + "."):
            return _leaf(v, dotted[len(k) + 1:])
    raise KeyError(dotted)


def _refusals(errors):
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    for name, call in (
        ("mesh_size", lambda: make_mesh((2, 3), ("data", "model"), device="cpu")),
        ("production", lambda: make_production_mesh(device="cpu")),
        ("production_pods", lambda: make_production_mesh(multi_pod=True, device="cpu")),
        ("mesh_backend", lambda: make_mesh(*MESH, device="cuda")),
    ):
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)


def run_rank(rank: int, store_path: str, out_dir: str) -> None:
    """Every case on this rank; each rank saves ``r<rank>.npz`` and
    ``r<rank>.json`` (its coordinates and the errors it saw)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import axis_coords
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    os.environ["REPRO_TORCH_AUTOTUNE_DISABLE"] = "1"
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        setup = dict(np.load(os.path.join(out_dir, "setup.npz")))
        mesh = make_mesh(*MESH, device="cpu")
        out, errors = {}, {}
        _moe(setup, mesh, out)
        _attention(setup, mesh, out)
        _train(setup, mesh, out)
        _memory(mesh, out)
        _serve(setup, mesh, out)
        _storage(setup, errors)
        _refusals(errors)
        facts = {"coords": axis_coords(mesh), "errors": errors,
                 "world": dist.get_world_size()}
        np.savez(os.path.join(out_dir, f"r{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
            json.dump(facts, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
