"""Batched serving: prefill a batch of prompts, decode N tokens.

The model is float32 with weights initialised from ``--seed``; the
prompts come from the same seed, as the JAX package's ``launch/serve.py``
builds them: a VLM's ``--prompt-len`` positions are its ``n_patches``
patch embeddings and the text tokens after them, and an encoder-decoder
model's encoder takes ``--prompt-len`` frame embeddings; both are drawn
from N(0, 1) in float32.  Every decode step attends to the *fixed*
prefill cache plus the new token, at the absolute position
``prompt_len + i``, the reference's semantics: nothing is appended to
the cache.  Every architecture of ``configs.ALL.ARCH_IDS`` serves.

On the card the decode step is captured once, at the first step, as a
CUDA graph (``launch/graphs.StepGraph``) and replayed at every step, as
the reference compiles its decode once with ``jax.jit``: the step's
shapes never change, only the values of ``tokens`` and ``pos``.  The
capture counts in ``decode_s`` as the reference's compile does.
Sampling runs outside the graph.  On a CPU device the decode runs
eagerly.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --smoke \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --smoke \
      --device cpu
"""

from __future__ import annotations

import argparse
import statistics
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from ..configs.ALL import config
from ..kernels.policy import resolve_device
from ..models.model import Model
from .graphs import StepGraph

__all__ = ["ServeRun", "parse_args", "run", "main"]


@dataclass
class ServeRun:
    """What one serve produced.

    Attributes:
        model: The model that served.
        prompts: ``(B, prompt_len - n_patches)`` prompt token ids on the
            model's device.
        inputs: The whole prefill batch: ``"tokens"`` (``prompts``), and
            ``"patches"`` (B, n_patches, d) or ``"src_embeds"`` (B,
            prompt_len, d) where the config takes them.
        prefill_logits: ``(B, 1, vocab)`` logits of the last prompt token.
        tokens: ``(B, gen+1)`` generated token ids on the host: the
            prefill's greedy token, then one per decode step.
        prefill_s: Prefill wall time, synchronised, in seconds.
        decode_s: Wall time of the decode steps, in seconds, the capture
            included.
        caches: The prefill's caches, which every decode step reads.
        decode: One decode step, ``decode({"tokens": (B, 1), "pos": (B,)})
            -> logits (B, 1, vocab)``, against ``caches``: on the card the
            captured graph, whose logits are a static buffer that its next
            call overwrites; on the CPU ``model.decode``.
        capture_s: Seconds of the graph's warm-up and capture, inside the
            first step; ``None`` on the CPU.
        step_s: Each decode step's wall time, synchronised, in seconds
            (the first includes the capture).
    """

    model: Model
    prompts: torch.Tensor
    inputs: dict
    prefill_logits: torch.Tensor
    tokens: torch.Tensor
    prefill_s: float
    decode_s: float
    caches: dict
    decode: Callable[[dict], torch.Tensor]
    capture_s: Optional[float]
    step_s: List[float]


def parse_args(argv=None) -> argparse.Namespace:
    """The server's command line."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers, a config's prefix layers "
                    "included (default: the config's)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> ServeRun:
    """Build the model, prefill the prompts and decode ``args.gen`` tokens."""
    cfg = config(args.arch, smoke=args.smoke).replace(act_dtype="float32",
                                                      param_dtype="float32")
    if args.n_layers:
        cfg = cfg.replace(n_layers=args.n_layers)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Model(cfg, device=device).init(gen)
    b, s = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab, (b, s - cfg.n_patches), generator=gen, device=device)
    inputs = {"tokens": prompts}
    if cfg.n_patches:
        inputs["patches"] = torch.randn((b, cfg.n_patches, cfg.d_model), generator=gen,
                                        device=device)
    if cfg.encoder_layers:
        inputs["src_embeds"] = torch.randn((b, s, cfg.d_model), generator=gen, device=device)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = model.prefill(inputs)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    prefill_logits = logits
    tok = logits[:, -1].argmax(-1)[:, None]
    out = [tok]
    pos = torch.empty((b,), dtype=torch.long, device=device)

    def eager(step):
        return model.decode(caches, step)[0]

    decode, capture_s, step_s = eager, None, []
    for i in range(args.gen):
        t0 = time.perf_counter()
        pos.fill_(s + i)
        step = {"tokens": tok, "pos": pos}
        if i == 0 and device.type != "cpu":
            decode = StepGraph(eager, step)
            capture_s = decode.capture_s
        logits = decode(step)
        if args.temperature > 0:
            probs = torch.softmax(logits[:, -1] / args.temperature, -1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
        _sync(device)
        step_s.append(time.perf_counter() - t0)
    tokens = torch.cat(out, 1).cpu()
    return ServeRun(model, prompts, inputs, prefill_logits, tokens, prefill_s, sum(step_s),
                    caches, decode, capture_s, step_s)


def main(argv=None) -> torch.Tensor:
    """Serve from the command line; returns the ``(B, gen+1)`` token ids."""
    args = parse_args(argv)
    r = run(args)
    b, s = args.batch, args.prompt_len
    print(f"prefill {s} tokens x {b}: {r.prefill_s:.2f}s")
    rate = args.gen * b / r.decode_s if r.decode_s > 0 else float("inf")
    print(f"decoded {args.gen} tokens x {b} in {r.decode_s:.2f}s ({rate:.1f} tok/s)")
    if r.capture_s is not None:
        steady = statistics.median(r.step_s[1:]) if len(r.step_s) > 1 else float("nan")
        print(f"decode graph captured in {r.capture_s:.2f}s; median replayed step "
              f"{steady * 1e3:.2f} ms")
    print("sample token ids:", r.tokens[0][:16].tolist())
    return r.tokens


if __name__ == "__main__":
    main()
