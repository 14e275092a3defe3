"""The JAX side of ``tests/test_torch_dryrun.py``: the JAX package's own
dry-run figures of one reduced architecture's train, prefill and decode
cells on a (2, 2) ``data``/``model`` mesh of four host devices:
``memory_analysis().argument_size_in_bytes`` and the loop-aware
``analyze_hlo`` FLOPs of each compiled step (per device), printed as one
JSON line ``{mode: {...}}``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/port_dryrun_jax.py <arch> <seq> <batch>
"""

import json
import os
import sys


def main(arch: str, seq: int, batch: int) -> None:
    """Lower and compile each mode's step; print the figures."""
    os.environ["REPRO_AUTOTUNE_DISABLE"] = "1"
    from repro.configs.ALL import REDUCED
    from repro.configs.base import ShapeCfg
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build
    from repro.roofline.hlo_cost import analyze_hlo

    cfg = REDUCED[arch]().replace(act_dtype="float32", param_dtype="float32")
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for mode in ("train", "prefill", "decode"):
        compiled = build(cfg, mesh, ShapeCfg("c", seq, batch, mode)).lower().compile()
        out[mode] = {"argument_size": compiled.memory_analysis().argument_size_in_bytes,
                     "flops_per_device": analyze_hlo(compiled.as_text())["flops"]}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
