"""The JAX side of ``tests/test_torch_lm_spmd.py``: the JAX package's own
mesh paths on a (2, 2) ``data``/``model`` mesh of four host devices, on
the inputs of ``<dir>/setup.npz``, saved to ``<dir>/jax_<part>.npz``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/port_lm_jax.py <dir> forms|serve

The two parts run at once in two processes.  Part ``forms`` runs
``moe_apply`` in its TP and EP forms, ``sharded_causal_attention``
in its three mesh cases, one ``build(...).jit_train()`` step of each
``JIT_TRAIN`` case (the reduced yi-6b in float32, AdamW and Adafactor);
part ``serve`` each serve case's ``prefill_step_fn()`` then
``serve_step_fn()`` ``DECODE_STEPS`` times against the prefill's caches
(placed by the bundle's ``cspecs``), each step fed the argmax of the step
before.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import port_lm_spmd as P  # noqa: E402


def _tree(flat, sds):
    """The JAX tree of ``sds``'s structure with leaves from ``flat`` by
    their dotted path."""
    import jax

    leaves = []
    for path, _ in jax.tree_util.tree_flatten_with_path(sds)[0]:
        leaves.append(flat[".".join(str(getattr(k, "key", k)) for k in path)])
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(sds), leaves)


def _flat(tree, prefix):
    import jax

    return {prefix + ".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _serve(setup, mesh) -> dict:
    """Each serve case's prefill and decode steps through the reference's
    ``StepBundle``."""
    import jax
    import jax.numpy as jnp

    from repro.configs.ALL import REDUCED
    from repro.configs.base import ShapeCfg
    from repro.launch.steps import build

    out = {}
    for name, (arch, fields, b, s) in P.SERVE_CASES.items():
        cfg = REDUCED[arch]().replace(**P.F32, **fields)
        bundle = build(cfg, mesh, ShapeCfg("d", s, b, "decode"))
        key = P.weights_key(arch, fields) + "."
        params = jax.device_put(_tree({k[len(key):]: v for k, v in setup.items()
                                       if k.startswith(key)}, bundle.params_sds),
                                bundle.pspecs)

        def put(x, k, bundle=bundle):
            return jax.device_put(jnp.asarray(x, jnp.int32), bundle.bspecs[k])

        logits, caches = jax.jit(bundle.prefill_step_fn())(
            params, {"tokens": put(setup[f"serve.{name}.tokens"], "tokens")})
        caches = jax.device_put(caches, bundle.cspecs)
        out[f"serve.{name}.cache_bytes"] = np.array(sum(
            x.addressable_shards[0].data.nbytes for x in jax.tree_util.tree_leaves(caches)))
        serve = jax.jit(bundle.serve_step_fn())
        got = [np.asarray(logits)]
        for i in range(P.DECODE_STEPS):
            step = {"tokens": put(got[-1][:, -1].argmax(-1)[:, None], "tokens"),
                    "pos": put(np.full((b,), s + i), "pos")}
            logits, _ = serve(params, caches, step)
            got.append(np.asarray(logits))
        out[f"serve.{name}"] = np.stack(got)
    return out


def _forms(setup, mesh) -> dict:
    """The MoE and attention mesh forms and one ``jit_train()`` step."""
    import jax
    import jax.numpy as jnp

    from repro.configs.ALL import REDUCED
    from repro.configs.base import ShapeCfg
    from repro.launch.steps import build
    from repro.models.attention import sharded_causal_attention
    from repro.models.model import Model
    from repro.models.moe import moe_apply

    out = {}
    for name, fields in P.MOE_CASES.items():
        cfg = REDUCED["qwen2-moe-a2.7b"]().replace(**P.F32, **fields)
        layer = {k[len("moe_layer."):]: v for k, v in setup.items() if k.startswith("moe_layer.")}
        p = {k: layer[k] for k in ("router", "w1", "w3", "w2")}
        p["shared"] = {k: layer[f"shared.{k}"] for k in ("w1", "w3", "w2")}
        o, aux = jax.jit(lambda p, x, cfg=cfg: moe_apply(p, cfg, x, mesh))(p, setup["moe_x"])
        out[f"moe.{name}.out"], out[f"moe.{name}.aux"] = np.asarray(o), np.asarray(aux)
    for name, fields in P.ATTN_CASES.items():
        cfg = REDUCED["yi-6b"]().replace(**P.F32, **fields)
        q, k, v = (setup[f"attn.{name}.{t}"] for t in "qkv")
        o = jax.jit(lambda q, k, v, cfg=cfg: sharded_causal_attention(q, k, v, cfg, mesh))(q, k, v)
        out[f"attn.{name}"] = np.asarray(o)
    for name in P.JIT_TRAIN:
        arch, fields, b, s = P.TRAIN_CASES[name]
        cfg = REDUCED[arch]().replace(**P.F32, **fields)
        bundle = build(cfg, mesh, ShapeCfg("t", s, b, "train"))
        key = P.weights_key(arch, fields) + "."
        params = _tree({k[len(key):]: v for k, v in setup.items() if k.startswith(key)},
                       jax.eval_shape(lambda cfg=cfg: Model(cfg).init(jax.random.PRNGKey(0))))
        opt_state = bundle.opt.init(params)
        batch = {"tokens": jnp.asarray(setup[f"train.{name}.tokens"])}
        new_p, new_o, _, metrics = bundle.jit_train()(params, opt_state,
                                                      jnp.zeros((), jnp.int32), batch)
        out[f"train.{name}.loss"] = np.asarray(metrics["loss"])
        out.update(_flat(new_p, f"train.{name}.p."))
        out.update(_flat(new_o, f"train.{name}.o."))
    return out


def main(out_dir: str, part: str) -> None:
    """Run ``part`` (``forms`` or ``serve``) and save its results."""
    from repro.launch.mesh import make_mesh

    os.environ["REPRO_AUTOTUNE_DISABLE"] = "1"
    setup = dict(np.load(os.path.join(out_dir, "setup.npz")))
    mesh = make_mesh(*P.MESH)
    out = {"forms": _forms, "serve": _serve}[part](setup, mesh)
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
