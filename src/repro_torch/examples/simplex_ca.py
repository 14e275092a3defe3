"""Cellular automaton on simplex domains, the paper's flagship application
(§5.1: CA on the triangle with periodic bounds, on the tetrahedron with
free bounds), through the port (the JAX package's
``examples/simplex_ca.py``).

Runs Conway's game of life on a triangular domain with the H-grid
kernel and renders generations as ASCII; then steps a 3-D tetrahedral
CA with the exact table schedule and prints live-cell counts.

Run:  PYTHONPATH=src python -m repro_torch.examples.simplex_ca [--steps 8] [--n 64]
      [--device cpu]

Multi-device mode (DESIGN.md §7) runs a long sharded m=3 CA with k
shards of the fold partition, checkpointing every few generations and
surviving a simulated worker loss through the watchdog; the final state
is asserted bit-equal to an uninterrupted single-device engine run:

  PYTHONPATH=src python -m repro_torch.examples.simplex_ca --devices 4 \\
      [--steps 12] [--fail-at 5] [--executor engine|spmd] [--device cpu]

``--executor engine`` (the default) runs one process whose k shard
launches go round-robin over the visible cards (one card: all on
``cuda:0``).  ``--executor spmd`` starts k ranks of a
``torch.distributed`` group: gloo ranks on the CPU with ``--device cpu``,
else NCCL with one rank per card (k cards).
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..checkpoint import checkpointing as ckpt
from ..distributed.fault_tolerance import watchdog_restart
from ..distributed.simplex_sharding import ShardedSimplexCA, shard_mesh, shard_skew
from ..kernels import ops
from ..kernels import ref as R
from ..kernels.policy import resolve_device

__all__ = ["render", "single_device_demo", "sharded_demo", "spmd_demo", "main"]


def render(state, max_rows: int = 24) -> str:
    """ASCII rows of a triangular state, ``o`` alive and ``.`` dead."""
    s = torch.as_tensor(state).cpu()
    n = s.shape[0]
    step = max(1, n // max_rows)
    lines = []
    for r in range(0, n, step):
        row = s[r, : r + 1 : step].tolist()
        lines.append(" ".join("o" if c else "." for c in row))
    return "\n".join(lines)


def _random(shape, p: float, seed: int, mask) -> torch.Tensor:
    """A 0/1 int32 state of density ``p`` from ``seed``, zero off ``mask``."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) < p).to(torch.int32) * mask


def single_device_demo(args, device) -> None:
    """Render the 2-D hmap CA, then print the 3-D table CA's counts."""
    n, nb = args.n, args.n // args.rho
    state = _random((n, n), 0.35, 42, R.tril_mask(n, torch.int32)).to(device)
    print(f"2-simplex CA, n={n}, H-grid kernel ({nb // 2}x{nb + 1} blocks vs "
          f"{nb * nb} for BB)")
    for t in range(args.steps):
        print(f"\n-- generation {t} (alive={int(state.sum())}) --")
        print(render(state))
        state = ops.simplex_ca2d(state, rho=args.rho, kind="hmap", device=device)

    print("\n3-simplex CA (free boundaries, exact table schedule):")
    n3 = 32
    s3 = _random((n3,) * 3, 0.3, 43, R.tetra_mask(n3, torch.int32)).to(device)
    for t in range(4):
        print(f"  gen {t}: alive={int(s3.sum())}")
        s3 = ops.simplex_ca3d(s3, rho=4, kind="table", device=device)
    print(f"  gen 4: alive={int(s3.sum())}")


def _init3(n: int, device) -> torch.Tensor:
    return _random((n,) * 3, 0.3, 7, R.tetra_mask(n, torch.int32)).to(device)


def _truth(init: torch.Tensor, steps: int, device) -> torch.Tensor:
    """An uninterrupted single-device engine run of ``steps`` generations."""
    want = init
    for _ in range(steps):
        want = ops.simplex_ca_md(want, kind="table", device=device)
    return want


def _ca_loop(args, runner, init, ckpt_dir: str, executor: str, rank: int = 0):
    """The watchdog's run: resume from the latest checkpoint, step the
    CA, checkpoint every ``--ckpt-every`` generations, and raise once at
    ``--fail-at`` (a simulated worker loss)."""
    fail_at = {"step": args.fail_at}  # one-shot
    spmd = executor == "spmd"

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    def train(start_step):
        if start_step is None:
            state, t0 = init, 0
        else:
            tree, t0 = ckpt.restore_latest(ckpt_dir, {"state": init})
            state = tree["state"]
            say(f"  [watchdog] resumed from checkpoint step {t0}")
        for t in range(t0, args.steps):
            if fail_at["step"] is not None and t == fail_at["step"]:
                fail_at["step"] = None
                raise RuntimeError(f"simulated worker loss at generation {t}")
            state = runner.step(state, executor=executor)
            full = state.full_tensor() if spmd else state
            if (t + 1) % args.ckpt_every == 0 or t + 1 == args.steps:
                if rank == 0:
                    ckpt.save(ckpt_dir, t + 1, {"state": full.cpu()})
                if spmd:
                    dist.barrier()
            say(f"  gen {t + 1}: alive={int(full.sum())}")

    return train


def _check(args, init, ckpt_dir: str, device, restarts: int) -> None:
    """Hold the last checkpoint against an uninterrupted engine run."""
    print(f"watchdog restarts: {restarts}")
    tree, _ = ckpt.restore_latest(ckpt_dir, {"state": init})
    exact = torch.equal(_truth(init, args.steps, device), tree["state"])
    print(f"sharded result bit-equals single-device engine: {exact}", flush=True)
    if not exact:
        raise SystemExit("sharded CA diverged from single-device engine")


def _describe(runner, k: int, what: str) -> None:
    print(f"3-simplex CA sharded {k} ways, {what} (n={runner.n}, "
          f"{runner.base.steps} blocks, fold skew {shard_skew(runner.base, k):.4f})")
    for sh in runner.shards:
        print(f"  shard {sh.shard.index}: {sh.steps} blocks, step ranges {sh.ranges}")


def sharded_demo(args, device) -> None:
    """The sharded m=3 CA through the engine executor in this process."""
    k = args.devices
    if device.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    runner = ShardedSimplexCA(3, args.n3, k, kind="table", devices=devices)
    _describe(runner, k, f"engine launches on {[str(d) for d in devices]}")
    init = _init3(args.n3, device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="simplex_ca_ckpt_")
    try:
        restarts = watchdog_restart(_ca_loop(args, runner, init, ckpt_dir, "engine"),
                                    ckpt_dir)
        _check(args, init, ckpt_dir, device, restarts)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def _spmd_rank(rank: int, args, store_path: str, ckpt_dir: str) -> None:
    """One rank of the SPMD demo: gloo on the CPU, NCCL on card ``rank``."""
    k = args.devices
    if args.device == "cpu":
        torch.set_num_threads(1)
        device, backend = torch.device("cpu"), "gloo"
    else:
        device, backend = torch.device("cuda", rank), "nccl"
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.FileStore(store_path, k), rank=rank,
                            world_size=k, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = shard_mesh(k, device=device)
        runner = ShardedSimplexCA(3, args.n3, k, kind="table", mesh=mesh)
        if rank == 0:
            _describe(runner, k, f"SPMD slabs over {k} {backend} ranks")
        init = _init3(args.n3, device)
        restarts = watchdog_restart(_ca_loop(args, runner, init, ckpt_dir, "spmd", rank),
                                    ckpt_dir)
        if rank == 0:
            _check(args, init, ckpt_dir, device, restarts)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spmd_demo(args) -> None:
    """Start ``--devices`` ranks of the SPMD demo and wait for them."""
    k = args.devices
    if args.device != "cpu" and torch.cuda.device_count() < k:
        raise SystemExit(f"the SPMD executor takes one card a rank: need {k}, found "
                         f"{torch.cuda.device_count()} (or run the ranks with --device cpu)")
    if args.n3 % k:
        raise SystemExit(f"--n3 {args.n3} must divide over {k} ranks")
    work = tempfile.mkdtemp(prefix="simplex_ca_spmd_")
    ckpt_dir = args.ckpt_dir or os.path.join(work, "ckpt")
    try:
        mp.spawn(_spmd_rank, args=(args, os.path.join(work, "store"), ckpt_dir), nprocs=k,
                 join=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> None:
    """Parse the command line and run the chosen demo."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--n3", type=int, default=32, help="m=3 side length for --devices mode")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--rho", type=int, default=8)
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the m=3 CA k ways (0 = off)")
    ap.add_argument("--executor", choices=("engine", "spmd"), default="engine")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a worker loss at this generation")
    ap.add_argument("--ckpt-every", type=int, default=3)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions (default: the card)")
    args = ap.parse_args(argv)

    if args.devices and args.executor == "spmd":
        spmd_demo(args)
        return
    device = resolve_device(args.device)
    if args.devices:
        sharded_demo(args, device)
    else:
        single_device_demo(args, device)


if __name__ == "__main__":
    main()
