#!/usr/bin/env python3
"""Where the time of capturing the serving decode as a CUDA graph goes.

Full-width yi-6b (32 layers, float32, batch 4, prompt 2048), served as
``launch/serve.py`` serves it (its decode captured by
``launch/graphs.StepGraph``), then the same decode step captured again
by hand, split into its parts: the eager warm-up calls on a side stream,
``empty_cache`` (``torch.cuda.graph`` frees the allocator's cached blocks
before a capture; ``StepGraph`` does not), the step's Python run under
capture, ``capture_end`` (the graph's instantiation) and the first
replay, each timed with the host clock around synchronised work.  Each
variant runs twice after 8 GiB of blocks were cached: (A) three warm-up
calls and ``empty_cache``, as ``torch.cuda.graph`` and its documented
warm-up capture, (B) ``StepGraph``'s two warm-up calls without
``empty_cache``, (C) one warm-up call without it.  Every
replayed step's logits are held bit for bit against the eager step's.
Prints one ``capture`` line a variant beside the card's name and power
limit.

Run from the repository root on a card::

    python3 scripts/decode_capture_costs.py
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

VARIANTS = (("A", 3, True), ("B", 2, False), ("C", 1, False))


def main() -> int:
    import torch

    from repro_torch.launch import serve

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    r = serve.run(serve.parse_args(["--arch", "yi-6b", "--batch", "4", "--prompt-len", "2048",
                                    "--gen", "2", "--temperature", "0"]))
    print(f"serve capture_s={r.capture_s:.4f} card={card}", flush=True)
    r.decode = None
    step = {"tokens": r.tokens[:, :1].to(dev),
            "pos": torch.full((4,), 2048, dtype=torch.long, device=dev)}
    want = r.model.decode(r.caches, step)[0]

    def fn(inputs):
        return r.model.decode(r.caches, inputs)[0]

    ok = True
    for run in (1, 2):
        for tag, warm, empty in VARIANTS:
            cached = [torch.empty(2**30, dtype=torch.uint8, device=dev) for _ in range(8)]
            del cached
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            inputs = {k: v.clone() for k, v in step.items()}
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(warm):
                    fn(inputs)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            if empty:
                torch.cuda.empty_cache()
            t.append(time.perf_counter())
            with torch.cuda.stream(side):
                graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                    capture_error_mode="thread_local")
                try:
                    out = fn(inputs)
                finally:
                    t.append(time.perf_counter())
                    graph.capture_end()
            t.append(time.perf_counter())
            graph.replay()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            equal = torch.equal(out, want)
            ok = ok and equal
            d = [b - a for a, b in zip(t, t[1:])]
            print(f"capture {tag} run {run}: warmup_s({warm})={d[0]:.4f} "
                  f"empty_cache_s={d[1]:.4f} capture_fn_s={d[2]:.4f} capture_end_s={d[3]:.4f} "
                  f"first_replay_s={d[4]:.4f} total_s={t[-1] - t[0]:.4f} bit_equal={equal} "
                  f"card={card}", flush=True)
            del graph, out
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
