"""Train an LM for a few hundred steps with checkpoints and resume,
through the port's trainer (the JAX package's ``examples/train_lm.py``).

Presets:
  --preset smoke  : reduced yi-6b (~0.14M parameters), 200 steps,
                    seq 128, batch 8 (default)
  --preset 100m   : ~100M parameters (yi-6b's geometry at width 768,
                    12 layers), 300 steps, seq 256, batch 8, 2 microbatches

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --preset smoke --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

from ..launch.train import main as train_main

__all__ = ["preset_argv", "main"]


def preset_argv(preset: str, steps: int = 0, ckpt_dir: str = "") -> list:
    """The trainer's command line of ``preset`` (``smoke`` or ``100m``)."""
    if preset == "smoke":
        argv = ["--arch", "yi-6b", "--smoke", "--steps", str(steps or 200), "--seq", "128",
                "--batch", "8", "--lr", "3e-3"]
    elif preset == "100m":
        argv = ["--arch", "yi-6b", "--smoke", "--steps", str(steps or 300), "--seq", "256",
                "--batch", "8", "--lr", "1e-3", "--d-model", "768", "--n-layers", "12",
                "--microbatches", "2"]
    else:
        raise ValueError(f"unknown preset {preset!r}; presets: smoke, 100m")
    if ckpt_dir:
        argv += ["--ckpt-dir", ckpt_dir, "--ckpt-every", "100"]
    return argv


def main(argv=None) -> list:
    """Run a preset from the command line; returns the losses."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    train_argv = preset_argv(args.preset, args.steps, args.ckpt_dir)
    if args.resume:
        train_argv.append("--resume")
    if args.device:
        train_argv += ["--device", args.device]
    losses = train_main(train_argv)
    drop = losses[0] - losses[-1] if losses else 0.0
    print(f"loss drop over run: {drop:.3f} "
          f"({'LEARNING' if drop > 0.3 else 'check config'})")
    return losses


if __name__ == "__main__":
    main()
