"""Batched serving: prefill a batch of prompts, then decode against the
caches, through the port's server (the JAX package's
``examples/serve_lm.py``: the reduced config, batch 4, 64-token prompts).

Its checks raise ``quickstart.ExampleCheckFailed``: the prefill logits are
finite, and every decoded token id is in the vocabulary.  The model runs
on the card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch jamba-v0.1-52b] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..configs.ALL import config
from ..launch import serve
from .quickstart import check

__all__ = ["main"]


def main(argv=None) -> torch.Tensor:
    """Serve from the command line; returns the ``(4, gen + 1)`` token ids."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b",
                    help="any architecture id (its reduced config is served)")
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    argv = ["--arch", args.arch, "--smoke", "--batch", "4", "--prompt-len", "64",
            "--gen", str(args.gen)] + (["--device", args.device] if args.device else [])
    run = serve.run(serve.parse_args(argv))
    vocab = config(args.arch, smoke=True).vocab
    print(f"prefill 64 tokens x 4: {run.prefill_s:.2f}s; decoded {args.gen} tokens x 4 in "
          f"{run.decode_s:.2f}s")
    print("sample token ids:", run.tokens[0][:16].tolist())
    check(bool(torch.isfinite(run.prefill_logits).all()), "prefill logits are finite")
    check(tuple(run.tokens.shape) == (4, args.gen + 1)
          and bool(((run.tokens >= 0) & (run.tokens < vocab)).all()),
          f"{args.gen + 1} token ids a row, all in the vocabulary of {vocab}")
    return run.tokens


if __name__ == "__main__":
    main()
