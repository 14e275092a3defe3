"""The port's partition rules and gradient compression against the JAX
package's, on abstract meshes (no devices, no process group).

For every architecture (``tests/port_specs.py``), on the ``(2, 2)``,
``(16, 16)`` and ``(2, 16, 16)`` meshes, with ``tp`` on and off and, for
the MoE architectures, the experts stored over ``'model'`` (``moe_ep``)
or not: every parameter's and AdamW and Adafactor state leaf's spec of
the reduced config (the full width's are in
``tests/test_torch_sharding_full.py``), and, reduced and full width, the
batch's at batch 1 and 8 in each mode and every cache leaf's (the
reference's rule on one period's leaf, then its real stacked specs and
the per-rank cache size beside them).  The
weights-resident serve specs are held against the reference's
``StepBundle`` of the reduced configs on the ``(2, 16, 16)`` mesh.
Compression is held bit for bit over 8 steps of error feedback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_specs as S
import port_threads  # noqa: F401  (one torch thread a worker)

from repro.configs.ALL import REDUCED as R_REDUCED
from repro.configs.base import ShapeCfg as RShape
from repro.distributed import compression as RC
from repro.launch.steps import build as r_build
from repro_torch.configs.ALL import ARCH_IDS, config
from repro_torch.configs.base import SHAPES, ShapeCfg
from repro_torch.distributed import compression as TC
from repro_torch.distributed import sharding as TS
from repro_torch.launch.steps import build
from repro_torch.models.convert import is_stacked, stacked_groups


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_the_reference(arch):
    S.check_param_and_opt_specs(arch, full=False)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch, full):
    S.check_batch_and_cache_specs(arch, full)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_specs_drop_fsdp_as_the_reference(arch):
    mesh, sizes = S.meshes()[2]
    for tp in (True, False):
        fields = {} if tp else {"tp_size": 1}
        ref = r_build(R_REDUCED[arch]().replace(**fields), mesh, RShape("d", 64, 8, "decode"))
        rflat = S.ref_flat(jax.tree_util.tree_map(lambda s: s.spec, ref.pspecs,
                                                 is_leaf=lambda x: hasattr(x, "spec")),
                          ref.params_sds)
        mine = build(config(arch, smoke=True).replace(**fields), sizes,
                     ShapeCfg("d", 64, 8, "decode"))
        for key, members in stacked_groups(mine.pspecs).items():
            want = rflat[key][1:] if is_stacked(key) else rflat[key]
            for n in members:
                assert tuple(mine.pspecs[n]) == want, (tp, n)
                assert not {"pod", "data"} & set(
                    a for e in mine.pspecs[n] if e for a in ((e,) if isinstance(e, str) else e))


def test_specs_take_a_device_mesh_like_object_and_place_pod_major():
    class FakeMesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    assert TS.dp_axes(FakeMesh(), tp=False) == ("pod", "data", "model")
    spec = TS.Spec((("pod", "data"), "model"))
    pl = TS.placements(spec, {"pod": 2, "data": 16, "model": 16})
    assert [(p.is_shard(), getattr(p, "dim", None)) for p in pl] == [(True, 0), (True, 0),
                                                                     (True, 1)]
    with pytest.raises(ValueError, match="mesh's order"):
        TS.placements(TS.Spec((("data", "pod"),)), {"pod": 2, "data": 2, "model": 1})
    assert SHAPES["long_500k"].global_batch == 1
    assert TS.batch_specs({"tokens": (1, 2)}, {"data": 16, "model": 16}) == \
        {"tokens": (None, None)}


def _grads(rng, step):
    shapes = {"a": (17, 5), "b": (64,), "c": {"d": (3, 4, 6)}}

    def make(sh):
        if isinstance(sh, dict):
            return {k: make(v) for k, v in sh.items()}
        return (rng.standard_normal(sh) * 10.0 ** rng.integers(-4, 2)).astype(np.float32)

    return make(shapes)


def _leaves_np(tree, prefix=""):
    """{dotted path: numpy array} of a tree of dicts and (q, scale) pairs,
    from either library (bfloat16 widened to float32, exactly)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves_np(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, tuple):
        return {f"{prefix}q": _leaves_np(tree[0])[""], f"{prefix}scale": _leaves_np(tree[1])[""]}
    if isinstance(tree, torch.Tensor):
        x = tree.float() if tree.dtype == torch.bfloat16 else tree
        return {prefix[:-1]: x.numpy()}
    x = tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16 else tree
    return {prefix[:-1]: np.asarray(x)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_compression_is_the_reference_bit_for_bit(kind):
    rng = np.random.default_rng(5)
    g0 = _grads(rng, 0)
    r_err = RC.init_error_state(jax.tree_util.tree_map(jnp.asarray, g0))
    t_err = TC.init_error_state(_torch(g0))
    r_fn = {"bf16": RC.compress_bf16, "int8": RC.compress_int8}[kind]
    t_fn = {"bf16": TC.compress_bf16, "int8": TC.compress_int8}[kind]
    for step in range(8):
        g = _grads(rng, step)
        r_comp, r_err = r_fn(jax.tree_util.tree_map(jnp.asarray, g), r_err)
        t_comp, t_err = t_fn(_torch(g), t_err)
        for mine, ref in ((t_err, r_err), (t_comp, r_comp)):
            a, b = _leaves_np(mine), _leaves_np(ref)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (step, k)
        if kind == "int8":
            a, b = _leaves_np(TC.decompress_int8(t_comp)), _leaves_np(RC.decompress_int8(r_comp))
            assert all(np.array_equal(a[k], b[k]) for k in a)
