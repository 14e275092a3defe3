"""The rank program of ``tests/test_torch_spmd.py``: one rank of a gloo
group steps the sharded CA's SPMD executor and writes what it saw.

Spawned processes import this module by name, so it stays importable
from ``tests/`` and imports neither JAX nor the JAX package.
"""

import datetime
import json
import os

import numpy as np
import torch
import torch.distributed as dist

# (m, n, kind, generations, seed): m=2 wraps periodically, m=3 is free.
CASES = ((2, 32, "hmap", 1, 1), (2, 32, "hmap", 3, 2), (3, 16, "table", 1, 3),
         (3, 16, "table", 3, 4))


def state(m: int, n: int, seed: int) -> np.ndarray:
    """A 0/1 int32 state drawn on the domain (zeros off it)."""
    rng = np.random.default_rng(seed)
    s = (rng.random((n,) * m) < 0.4).astype(np.int32)
    idx = np.indices((n,) * m)
    dom = idx[1] <= idx[0] if m == 2 else idx.sum(0) < n
    return np.where(dom, s, 0).astype(np.int32)


def key(m: int, n: int, gens: int) -> str:
    """The result's name for a case."""
    return f"m{m}-n{n}-g{gens}"


def run_rank(rank: int, k: int, store_path: str, out_dir: str) -> None:
    """Every case on this rank; rank 0 saves the gathered results and the
    errors the helpers raised."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.distributed import simplex_sharding as SS

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, k), rank=rank,
                            world_size=k, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = SS.shard_mesh(k, device="cpu")
        results, facts = {}, {}
        for m, n, kind, gens, seed in CASES:
            runner = SS.ShardedSimplexCA(m, n, k, kind=kind, mesh=mesh)
            out = runner.run(torch.from_numpy(state(m, n, seed)), gens, executor="spmd")
            assert isinstance(out, DTensor) and tuple(out.placements) == (Shard(0),)
            assert tuple(out.to_local().shape) == (n // k,) + (n,) * (m - 1)
            results[key(m, n, gens)] = out.full_tensor().numpy()
        errors = {}
        for name, call in (
            ("mesh_size", lambda: SS.shard_mesh(k + 1, device="cpu")),
            ("mesh_backend", lambda: SS.shard_mesh(k, device="cuda")),
            ("state_divides", lambda: SS.shard_state(torch.zeros(4 * k + 1, 3), mesh)),
            ("runner_k", lambda: SS.ShardedSimplexCA(3, 16, 2 * k, kind="table",
                                                     mesh=mesh).step(torch.zeros(16, 16, 16),
                                                                     "spmd")),
        ):
            try:
                call()
                errors[name] = None
            except ValueError as e:
                errors[name] = str(e)
        facts["errors"] = errors
        facts["world"] = dist.get_world_size()
        if rank == 0:
            np.savez(os.path.join(out_dir, f"k{k}.npz"), **results)
            with open(os.path.join(out_dir, f"k{k}.json"), "w") as f:
                json.dump(facts, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
