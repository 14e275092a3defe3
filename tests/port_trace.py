"""The rank program of ``tests/test_torch_trace_cost.py``'s census test:
one rank of a 4-rank gloo group runs the mesh form of causal attention
(``models/attention.py``) on a (2, 2) ``data``/``model`` mesh under
``torch.profiler`` and saves the trace's collective census beside the
bytes of the collectives ``distributed/collectives.py`` issues, counted
from their shapes.

Spawned processes import this module by name, so it imports neither JAX
nor the JAX package; torch is imported inside ``run_rank``.
"""

import datetime
import json
import os

WORLD = 4
MESH = ((2, 2), ("data", "model"))
SHAPE = (4, 4, 32, 16)  # (B, Hq, S, D) of q, k and v


def run_rank(rank: int, store_path: str, out_dir: str) -> None:
    """The forward under the profiler; saves ``r<rank>.json``."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.ALL import REDUCED
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import sharded_causal_attention
    from repro_torch.roofline.trace_cost import summarize

    torch.set_num_threads(1)
    os.environ["REPRO_TORCH_AUTOTUNE_DISABLE"] = "1"
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(*MESH, device="cpu")
        b, h, s, d = SHAPE
        cfg = REDUCED["yi-6b"]().replace(act_dtype="float32", param_dtype="float32",
                                          n_heads=h, n_kv_heads=h, d_model=h * d)
        g = torch.Generator().manual_seed(rank // 2)  # the same rows across 'model'
        q, k, v = (torch.randn((b // 2, h, s, d), generator=g) for _ in range(3))
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU],
                                      record_shapes=True) as prof:
            out = sharded_causal_attention(q, k, v, cfg, mesh)
        census = summarize(prof.events(), group_size=2)["collectives"]
        # exit_gather: one all-gather over 'model' of this rank's heads
        local = out.numel() // 2 * out.element_size()
        facts = {"census": census, "gathered_bytes": local, "out_shape": list(out.shape)}
        with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
            json.dump(facts, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
