"""End-to-end trainer with checkpoint and resume, the JAX package's
``launch/train.py``.

Deterministic data (step -> batch), atomic checkpoints and resume from
the latest, gradient accumulation over microbatches, and the prefill's
folded-simplex flash forward, here under autograd (``FlashFunction``).
As the reference does, training forces float32 activations and
parameters and ``remat="none"``.  The parameters come from ``--seed``
through a ``torch.Generator``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
      --steps 200 --device cpu --ckpt-dir /tmp/ckpt --resume
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from ..checkpoint import checkpointing as ckpt
from ..configs.ALL import config
from ..data.pipeline import SyntheticLM
from ..kernels.policy import resolve_device
from ..models.convert import load_stacked, stacked_params
from ..models.model import Model
from ..optim.optimizer import Optimizer, make_optimizer, warmup_cosine

__all__ = ["Trainer", "parse_args", "build", "loss_and_grads", "train_step", "train_tree",
           "load_train_tree", "run", "main"]


@dataclass
class Trainer:
    """What a training run holds.

    Attributes:
        model: The model, its parameters recording gradients.
        opt: The optimizer.
        opt_state: Its state (the reference's tree, float32).
        data: The batch stream.
        step0: The first step to run (after a resume, the checkpoint's).
        losses: The loss of each step run.
        ce: The next-token cross-entropy of each step run.
        aux: The experts' balance loss of each step run (0 for a dense
            model).
        grad_norms: The global gradient norm of each step run, before
            clipping.
        step_s: The wall time of each step run, synchronised, in seconds.
    """

    model: Model
    opt: Optimizer
    opt_state: Any
    data: SyntheticLM
    step0: int = 0
    losses: List[float] = field(default_factory=list)
    ce: List[float] = field(default_factory=list)
    aux: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)


def parse_args(argv=None) -> argparse.Namespace:
    """The trainer's command line (the reference's flags and ``--device``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--schedule-steps", type=int, default=0,
                    help="LR schedule horizon (defaults to --steps); set it when a run "
                    "will be interrupted and resumed")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0, help="override the width")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="override the depth, a config's prefix layers included")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def train_tree(t: Trainer) -> Dict[str, Any]:
    """``{"params": ..., "opt": ...}`` as the reference's trainer saves
    it: nested dicts under the reference's names, block parameters
    stacked over the periods (copies)."""
    return _nest({"params": stacked_params(t.model), "opt": t.opt_state})


def load_train_tree(t: Trainer, tree: Dict[str, Any]) -> None:
    """Put a restored ``train_tree`` into the model and optimizer state."""
    load_stacked(t.model, _flat(tree["params"]))
    flat_state = ckpt._flatten(_nest(t.opt_state))
    with torch.no_grad():
        for name, leaf in ckpt._flatten(tree["opt"]).items():
            flat_state[name].copy_(leaf)


def _nest(tree):
    """Split dotted keys into nested dicts (``{"a.b": x}`` ->
    ``{"a": {"b": x}}``), at every level."""
    if not isinstance(tree, dict):
        return tree
    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        *path, last = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = _nest(sub)
    return out


def _flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        out: Dict[str, torch.Tensor] = {}
        for key, sub in tree.items():
            out.update(_flat(sub, f"{prefix}{key}."))
        return out
    return {prefix[:-1]: tree}


def build(args: argparse.Namespace, cfg=None) -> Trainer:
    """The model (from ``--seed``), optimizer, data and, with ``--resume``,
    the latest checkpoint of ``--ckpt-dir``.  ``cfg``, where given, is
    trained in place of ``--arch``'s config (a caller's cut of it, such as
    fewer experts to fit one card); the float32 and remat overrides and
    ``--d-model``/``--n-layers`` apply to it as to that config."""
    cfg = cfg or config(args.arch, smoke=args.smoke)
    over = {"act_dtype": "float32", "param_dtype": "float32", "remat": "none"}
    if args.d_model:
        over["d_model"] = args.d_model
    if args.n_layers:
        over["n_layers"] = args.n_layers
    cfg = cfg.replace(**over)
    device = resolve_device(args.device)
    model = Model(cfg, device=device).init(torch.Generator(device=device).manual_seed(args.seed))
    model.requires_grad_(True)
    horizon = args.schedule_steps or args.steps
    opt = make_optimizer(cfg.optimizer, warmup_cosine(args.lr, horizon // 10 + 1, horizon))
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed, device=device)
    t = Trainer(model, opt, opt.init(dict(model.named_parameters())), data)
    if args.resume and args.ckpt_dir:
        restored, s = ckpt.restore_latest(args.ckpt_dir, train_tree(t))
        if restored is not None:
            load_train_tree(t, restored)
            t.step0 = s
            print(f"resumed from step {s}")
    return t


def loss_and_grads(model: Model, batch: Dict[str, torch.Tensor], microbatches: int = 1):
    """``(loss, grads)`` of ``model.loss`` on ``batch``, averaged over
    ``microbatches`` equal slices of its rows; ``grads`` by parameter name."""
    return _loss_grads_metrics(model, batch, microbatches)[:2]


def _loss_grads_metrics(model, batch, microbatches, mesh=None, leaves=None, bind=None):
    """``loss_and_grads`` and the loss's metrics (``ce``, ``aux``) as
    floats, averaged the same way; every input of ``batch`` is cut into
    the microbatches, and ``mesh`` and ``bind`` go to ``model.loss``.
    ``leaves`` (``{name: tensor}``) are differentiated in place of the
    parameters that record a gradient (the step bundle's shards, from
    which ``bind`` gathers each unit's parameters)."""
    if leaves is None:
        leaves = {n: p for n, p in model.named_parameters() if p.requires_grad}
        if not leaves:
            raise ValueError("no parameter records a gradient: call model.requires_grad_(True)")
    names = list(leaves)
    total, grads = None, None
    sums = {"ce": 0.0, "aux": 0.0}
    for i in range(microbatches):
        mb = {k: v.reshape((microbatches, -1) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
        loss, metrics = model.loss(mb, mesh, bind=bind)
        g = torch.autograd.grad(loss, list(leaves.values()))
        for key in sums:
            sums[key] += metrics[key].detach().item()
        if grads is None:
            total, grads = loss.detach(), [x.to(torch.float32) for x in g]
        else:
            total = total + loss.detach()
            for acc, x in zip(grads, g):
                acc.add_(x)
        del loss, g
    if microbatches > 1:
        total = total / microbatches
        grads = [x / microbatches for x in grads]
    return total, dict(zip(names, grads)), {k: v / microbatches for k, v in sums.items()}


def train_step(t: Trainer, step: int, batch: Dict[str, torch.Tensor],
               microbatches: int = 1) -> torch.Tensor:
    """One optimizer step on ``batch``; returns the loss before it and
    records its ``ce`` and ``aux`` in ``t``."""
    loss, grads, metrics = _loss_grads_metrics(t.model, batch, microbatches)
    t.ce.append(metrics["ce"])
    t.aux.append(metrics["aux"])
    _, t.opt_state = t.opt.update(grads, t.opt_state, dict(t.model.named_parameters()),
                                  step)
    return loss


def run(args: argparse.Namespace, t: Optional[Trainer] = None,
        batch_at: Optional[Callable[[int], Dict[str, torch.Tensor]]] = None) -> Trainer:
    """Train from ``t.step0`` to ``args.steps``: a batch per step from
    ``batch_at`` (default: the trainer's data), logs every
    ``--log-every`` steps and a checkpoint every ``--ckpt-every``."""
    t = t or build(args)
    batch_at = batch_at or t.data.batch_at
    dev = t.model.device
    n_params = sum(p.numel() for p in t.model.parameters())
    print(f"arch={t.model.cfg.name} params={n_params:,} steps={args.steps}")
    tokens = args.batch * args.seq
    for step in range(t.step0, args.steps):
        batch = batch_at(step)
        t0 = time.perf_counter()
        loss = train_step(t, step, batch, args.microbatches)
        t.losses.append(float(loss))
        t.grad_norms.append(float(t.opt_state["gnorm"]))  # waits for the step
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t.step_s.append(time.perf_counter() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {t.losses[-1]:.4f}  ce {t.ce[-1]:.4f}  "
                  f"aux {t.aux[-1]:.6f}  tok/s {tokens * len(t.step_s) / sum(t.step_s):,.0f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, train_tree(t))
            print(f"checkpoint @ {step + 1}")
    if t.losses:
        print(f"first-loss {t.losses[0]:.4f}  last-loss {t.losses[-1]:.4f}")
    return t


def main(argv=None) -> List[float]:
    """Train from the command line; returns the loss of each step run."""
    return run(parse_args(argv)).losses


if __name__ == "__main__":
    main()
