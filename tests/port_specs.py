"""Shared checks of the port's partition rules against the JAX package's
(imported by ``tests/test_torch_sharding.py`` and
``tests/test_torch_sharding_full.py``).

The rules are pure functions of the axis sizes, so the reference runs on a
``jax.sharding.AbstractMesh`` and the port on the same ``{axis: size}``
mapping, on the ``(2, 2)``, ``(16, 16)`` and ``(2, 16, 16)`` meshes.  A
per-period parameter's spec is the reference's stacked spec without its
leading ``None``; the optimizer state is the reference's stacked tree.
"""

import functools
import math

import jax
import jax.numpy as jnp
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs.ALL import REDUCED as R_REDUCED
from repro.configs.base import ShapeCfg as RShape
from repro.configs.base import get_config
from repro.distributed import sharding as RS
from repro.models.model import Model as RModel
from repro.optim import optimizer as RO
from repro_torch.configs.ALL import config
from repro_torch.configs.base import ShapeCfg
from repro_torch.distributed import sharding as TS
from repro_torch.launch.steps import input_shapes
from repro_torch.models.convert import is_stacked, stacked_groups
from repro_torch.models.model import Model
from repro_torch.optim import optimizer as TO

MESHES = [((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHE_SEQ = 64
BATCHES = (1, 8)
OPTIMIZERS = ("adamw", "adafactor")

# The port's per-rank cache elements over the reference's, at full width,
# in every (architecture, batch, mesh, tp) cell where they are not equal.
# The port places its caches as the reference's stacked specs do, so no
# cell differs.
CACHE_RATIO_FULL = {}


def meshes():
    """(AbstractMesh, {axis: size}) of each mesh."""
    return [(AbstractMesh(shape, axes), dict(zip(axes, shape))) for shape, axes in MESHES]


def ref_cfg(arch, full):
    """The reference's config, full or reduced."""
    return get_config(arch) if full else R_REDUCED[arch]()


def port_cfg(arch, full):
    """The port's config, full or reduced."""
    return config(arch, smoke=not full)


def _path(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def ref_flat(specs, tree):
    """{dotted path: tuple(spec)} of a reference spec tree over ``tree``."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {_path(p): tuple(s) for (p, _), s in zip(leaves, flat)}


def port_flat(tree, prefix=""):
    """{dotted path: tuple(spec)} of a port spec tree (list indices too)."""
    if isinstance(tree, TS.Spec):
        return {prefix[:-1]: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(port_flat(v, f"{prefix}{k}."))
    return out


@functools.lru_cache(maxsize=None)
def ref_trees(arch, full):
    """The reference's parameter shapes and AdamW and Adafactor states."""
    params = jax.eval_shape(lambda: RModel(ref_cfg(arch, full)).init(jax.random.PRNGKey(0)))
    lr = RO.warmup_cosine(3e-4, 2000, 100_000)
    return params, {k: jax.eval_shape(RO.make_optimizer(k, lr).init, params)
                    for k in OPTIMIZERS}


@functools.lru_cache(maxsize=None)
def port_trees(arch, full):
    """The port's meta model, its named parameters and both states."""
    model = Model(port_cfg(arch, full), device="meta")
    meta = dict(model.named_parameters())
    lr = TO.warmup_cosine(3e-4, 2000, 100_000)
    return model, meta, {k: TO.make_optimizer(k, lr).init(meta) for k in OPTIMIZERS}


def variants(arch):
    """(tp, moe_ep) pairs: ``moe_ep`` both ways for the MoE architectures."""
    moe = port_cfg(arch, False).moe is not None
    return [(tp, ep) for tp in (True, False) for ep in ((False, True) if moe else (False,))]


def check_param_and_opt_specs(arch, full):
    """Every parameter's and optimizer-state leaf's spec equal to the
    reference's, on every mesh and variant."""
    params, ropt = ref_trees(arch, full)
    _, meta, topt = port_trees(arch, full)
    groups = stacked_groups(meta)
    for mesh, sizes in meshes():
        for tp, ep in variants(arch):
            rspec = RS.param_specs(params, mesh, tp, ep)
            rflat = ref_flat(rspec, params)
            mine = TS.param_specs(meta, sizes, tp, ep)
            assert set(mine) == set(meta)
            for key, members in groups.items():
                want = rflat[key][1:] if is_stacked(key) else rflat[key]
                for n in members:
                    assert tuple(mine[n]) == want, (sizes, tp, ep, n, mine[n], want)
            for kind in OPTIMIZERS:
                ro = RS.opt_state_specs(ropt[kind], rspec, params, mesh)
                to = TS.opt_state_specs(topt[kind], mine, meta, sizes)
                assert port_flat(to) == ref_flat(ro, ropt[kind]), (sizes, tp, ep, kind)


def _per_rank(shape, spec, sizes) -> int:
    """Elements of one rank's block of a ``shape`` leaf under ``spec``."""
    n = 1
    for d, e in zip(shape, spec):
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        n *= d // math.prod(sizes[a] for a in axes)
    return n


def check_batch_and_cache_specs(arch, full):
    """Every batch leaf's spec (each mode, batch 1 and 8) equal to the
    reference's.  The cache specs of the bundle's stacked layout
    (``stacked_cache``) equal to the reference's real specs leaf for
    leaf; at full width, the per-rank cache size of the
    stacked layout over the reference's is ``CACHE_RATIO_FULL``'s (1 where
    it does not name the cell)."""
    rmodel, tcfg = RModel(ref_cfg(arch, full)), port_cfg(arch, full)
    tmodel = port_trees(arch, full)[0]
    for b in BATCHES:
        rcache = jax.eval_shape(lambda: rmodel.init_cache(b, CACHE_SEQ, jnp.bfloat16))
        rshapes = {_path(p): tuple(x.shape)
                   for p, x in jax.tree_util.tree_flatten_with_path(rcache)[0]}
        tcache = TS.map_specs(lambda _, t: tuple(t.shape),
                              tmodel.init_cache(b, CACHE_SEQ, torch.bfloat16))
        stacked = TS.stacked_cache(tcache)
        tshapes = {n: s for n, s in port_flat(TS.map_specs(lambda _, t: TS.Spec(t), stacked)
                                              ).items()}
        assert tshapes == rshapes, (b, tshapes, rshapes)
        for mesh, sizes in meshes():
            for tp in (True, False):
                for mode in ("train", "prefill", "decode"):
                    rb = RS.batch_specs(rmodel.input_specs(RShape("c", CACHE_SEQ, b, mode)),
                                        mesh, tp)
                    tb = TS.batch_specs(input_shapes(tcfg, ShapeCfg("c", CACHE_SEQ, b, mode)),
                                        sizes, tp)
                    assert {k: tuple(v) for k, v in rb.items()} == \
                        {k: tuple(v) for k, v in tb.items()}, (sizes, tp, mode, b)
                real = ref_flat(RS.cache_specs(rcache, mesh, tp), rcache)
                mine = port_flat(TS.cache_specs(stacked, sizes, tp))
                assert mine == real, (sizes, tp, b)
                if full:
                    ours = sum(_per_rank(tshapes[n], TS.Spec(mine[n]), sizes) for n in mine)
                    ref = sum(_per_rank(rshapes[n], real[n], sizes) for n in real)
                    key = (arch, b, tuple(sizes.values()), tp)
                    assert round(ours / ref, 3) == CACHE_RATIO_FULL.get(key, 1.0), \
                        (key, ours / ref)
