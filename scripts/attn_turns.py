#!/usr/bin/env python3
"""Time the attention tuner's candidates by what runs just before them.

At the serve shape in bfloat16 (B 4, Hq 32, Hkv 4, S 2048, D 128), where
flash-folded and flash-bb launch the same kernel (``flash16_wgmma``,
block_q 128) on grids of 1024 and 2048 blocks, on one card:

1. each flash executor's sample (``--calls`` back-to-back calls, timed
   with CUDA events) right after a sample of the chunked executor, right
   after a sample of the other flash executor, and after ``--idle-ms`` of
   idle host, over ``--rounds`` rounds: the median, min and max of each;
2. ``chip_smoke.py``'s turn-taking timer (``TunerSmoke.batch_ms``) under
   the simplex cases' rule, which the attention cases used before (9
   rounds of samples of at least 5 ms, the candidates always in the order
   flash-folded, flash-bb, chunked), and under the attention cases' rule
   (``tuner_rounds(..., attention=True)``: 41 rounds of at least 20 ms,
   the order turning each round), alternated ``--reps`` times: each
   repetition's flash-folded over flash-bb and the pick (flash-folded,
   the tuner's) over the fastest.

Run from the repository root on a host with one CUDA card::

    python3 scripts/attn_turns.py [--rounds 30] [--reps 8]

Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import pathlib
import statistics
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (4, 32, 4, 2048, 128)  # (B, Hq, Hkv, S, D), chip_smoke.py's serve shape
IMPLS = ("flash-folded", "flash-bb", "chunked")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    """Run both parts and print one line per measurement."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--calls", type=int, default=6, help="calls a flash sample in part 1")
    ap.add_argument("--idle-ms", type=float, default=50.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("attn_turns.py: no CUDA device", file=sys.stderr)
        return 2
    cache = tempfile.TemporaryDirectory(prefix="attn_turns_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(cache.name, "autotune.json")
    cs = _chip_smoke()
    from repro_torch.kernels import _build, engine, ops, ref
    from repro_torch.models.attention import simplex_attention

    card = cs._card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    smoke = cs.Smoke(torch, engine, ops, ref, 0)
    b, hq, hkv, s, d = SHAPE
    g = smoke.gen(230 + s % 97)  # chip_smoke.py's attention tuner inputs
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=smoke.dev).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    fns = {impl: (lambda impl=impl: simplex_attention(q, k, v, impl=impl)) for impl in IMPLS}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()

    def sample(key, n):
        fn = fns[key]
        return smoke.time_ms(lambda: [fn() for _ in range(n)], runs=1, warm=0) / n

    other = {"flash-folded": "flash-bb", "flash-bb": "flash-folded"}
    after: dict = {}
    for _ in range(args.rounds):
        for before in ("chunked", "other", "idle"):
            for key in other:
                if before == "chunked":
                    sample("chunked", 2)
                elif before == "other":
                    sample(other[key], args.calls)
                else:
                    torch.cuda.synchronize()
                    time.sleep(args.idle_ms / 1e3)
                after.setdefault((key, before), []).append(sample(key, args.calls))
    for (key, before), ms in sorted(after.items()):
        print(f"after {key} {before}: median_ms={statistics.median(ms):.4f} "
              f"min_ms={min(ms):.4f} max_ms={max(ms):.4f} samples={len(ms)} card={card}")

    tune = cs.TunerSmoke(smoke, card)
    ratios: dict = {"simplex rule": [], "attention rule": []}
    for rep in range(args.reps):
        for name, attention in (("simplex rule", False), ("attention rule", True)):
            med = tune.batch_ms(fns, attention=attention)
            ratios[name].append(med["flash-folded"] / min(med.values()))
            print(f"rule {name} rep {rep}: rounds={tune.rounds} "
                  f"flash-folded_ms={med['flash-folded']:.4f} "
                  f"flash-bb_ms={med['flash-bb']:.4f} "
                  f"folded/bb={med['flash-folded'] / med['flash-bb']:.3f} "
                  f"pick/fastest={ratios[name][-1]:.3f} card={card}")
    for name, r in ratios.items():
        print(f"rule {name}: pick/fastest min={min(r):.3f} median={statistics.median(r):.3f} "
              f"max={max(r):.3f} over {len(r)} repetitions card={card}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
