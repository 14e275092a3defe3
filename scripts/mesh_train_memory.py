#!/usr/bin/env python3
"""Where a ``StepBundle`` train step's device memory peaks, on one card.

yi-6b at full width cut to 4 layers (float32, AdamW, batch 4 x 2048,
remat "none"), the ``mesh train`` row of ``chip_smoke.py``, on a (1, 1)
``data``/``model`` mesh over a one-rank NCCL group: one untimed step,
then one step with the parameters gathered in float32 and one in
bfloat16, each under ``torch.cuda.memory._record_memory_history``.  The
allocator's trace of each step is replayed: the most bytes the step
allocated above what was allocated before it, the allocation at that
moment, and the blocks alive then summed by the first frame of this
package that allocated them (``?``: a block with no Python frame, such as
an autograd engine's output).  Prints one ``memory`` JSON line per step
and its largest groups, beside the card's name and power limit.

Run from the repository root on a card::

    python3 scripts/mesh_train_memory.py
"""

from __future__ import annotations

import collections
import json
import os
import pathlib
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

GIB = 2**30
TOP = 14


def _where(frames) -> str:
    """The first frame of the package outside the step's own machinery."""
    ours = [f for f in frames if "repro_torch" in f["filename"]]
    for f in ours:
        if not f["filename"].endswith(("launch/steps.py", "launch/train.py")):
            ours = [f]
            break
    if not ours:
        return "?"
    f = ours[0]
    return f"{f['filename'].split('repro_torch/')[1]}:{f['line']}:{f['name']}"


def _peak(trace):
    """``(bytes, event index, {site: bytes})`` at the trace's peak."""
    live, cur, best, at, alive = {}, 0, 0, 0, {}
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], _where(e.get("frames", [])))
            cur += e["size"]
            if cur > best:
                best, at, alive = cur, i, dict(live)
        elif e["action"] == "free_completed" and e["addr"] in live:
            cur -= live.pop(e["addr"])[0]
    sites = collections.Counter()
    for size, site in alive.values():
        sites[site] += size
    return best, at, sites


def main() -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("mesh_train_memory.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.ALL import config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    store = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store.name, "s"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        dev = torch.device("cuda", 0)
        cfg = config("yi-6b").replace(act_dtype="float32", param_dtype="float32", n_layers=4,
                                      remat="none")
        g = torch.Generator(device=dev).manual_seed(9100)
        model = Model(cfg, device=dev).init(g)
        batch = {"tokens": torch.randint(0, cfg.vocab, (4, 2049), generator=g, device=dev)}
        shape = ShapeCfg("train", 2048, 4, "train")
        bundle = steps.build(cfg, mesh, shape)
        params, state = bundle.shard_params(model), bundle.init_opt_state()
        params, state, _, _ = bundle.train_step(params, state, 0, batch)
        for i, gather in enumerate(("float32", "bfloat16"), 1):
            b = steps.build(cfg.replace(gather_dtype=gather), mesh, shape)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            torch.cuda.memory._record_memory_history(max_entries=400_000, stacks="python")
            params, state, _, _ = b.train_step(params, state, i, batch)
            torch.cuda.synchronize()
            trace = torch.cuda.memory._snapshot()["device_traces"][0]
            torch.cuda.memory._record_memory_history(enabled=None)
            best, at, sites = _peak(trace)
            print("memory " + json.dumps({
                "gather": gather, "allocated_before_gib": before / GIB,
                "peak_gib": torch.cuda.max_memory_allocated() / GIB,
                "step_peak_above_before_gib": best / GIB, "events": len(trace),
                "peak_event": at, "peak_site": _where(trace[at].get("frames", [])),
                "card": card}), flush=True)
            for site, n in sites.most_common(TOP):
                print(f"memory   {n / GIB:8.3f} GiB  {site}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
