"""The dry run: every (architecture x shape x mesh) cell counted on the CPU.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  The
reference lowers and compiles each cell on 512 host devices and reads
XLA's memory and cost analyses.  The port needs neither a process group
nor a tensor with memory: its partition rules are pure functions of an
``{axis: size}`` mapping (``distributed/sharding.py``), and its model runs
on the ``meta`` device.  For each cell it records

* the bytes one rank stores of the parameters, the optimizer state (to
  train) and the caches (to decode): the ``StepBundle``'s ``Spec`` trees
  through ``local_shape``, each leaf in its own dtype; to train, also the
  bytes one rank holds for the sharded update (``update_bytes``: the
  shards, and the parameters and gradients of the leaves outside every
  unit and of two units whole);
* FLOPs and bytes of one step from ``roofline.trace_cost.flop_count``
  over the step's math on ``meta`` tensors: the mesh-less model over the
  global batch (the loss and its gradients, microbatch by microbatch, to
  train; the forward to prefill; one token against ``init_cache``'s caches
  to decode).  Work that the mesh forms replicate over ``'model'`` is
  counted once, where the reference's per-device HLO times the chips
  counts it on every rank; the optimizer's elementwise update is not
  counted, as the reference counts only dots;
* the reference's other fields where they mean something here
  (``params``, ``params_active``, ``tokens``, ``microbatches``, and
  ``roofline``: ``roofline.analysis.roofline_terms`` on the card's
  peaks).  The collectives are not counted: no step runs on a mesh.

A cell the reference skips (``cell_skip_reason``) is recorded as a skip
with its reason.  A cell that fails is recorded with its error and the
sweep goes on, as the reference's does; the run then exits 1.

Records land in ``<outdir>/<mesh>/<arch>__<shape>.json`` (default
``experiments/dryrun``, which git ignores), meshes ``pod16x16`` and
``pod2x16x16``.

Usage::

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..configs.ALL import ARCH_IDS, config
from ..configs.base import SHAPES, ArchConfig, ShapeCfg
from ..distributed.collectives import axis_sizes
from ..distributed.sharding import Spec, _axes, local_shape, stacked_cache
from ..roofline.analysis import roofline_terms
from ..roofline.trace_cost import flop_count
from .steps import StepBundle, input_shapes

__all__ = ["MESHES", "cell_skip_reason", "rank_bytes", "unit_bytes", "update_bytes",
           "step_flops", "run_cell", "main"]

MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


def cell_skip_reason(cfg: ArchConfig, shape_name: str) -> Optional[str]:
    """The reference's reason to skip a cell, or None.

    Example:
        >>> cell_skip_reason(config("yi-6b"), "long_500k")[:40]
        'long_500k needs sub-quadratic attention;'
    """
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("long_500k needs sub-quadratic attention; "
                f"{cfg.name} is pure full-attention (DESIGN.md §5)")
    return None


def _flat(tree, path=()) -> Dict[tuple, object]:
    """``{path: leaf}`` of a tree of dicts, lists and tuples (a ``Spec`` is
    a leaf)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, path + (str(k),)))
    return out


def _stored(tensors, specs, sizes: Mapping[str, int]) -> int:
    """Bytes one rank stores of a tree of ``meta`` tensors under a
    parallel tree of specs."""
    specs = _flat(specs)
    return sum(math.prod(local_shape(t.shape, specs[p], sizes)) * t.element_size()
               for p, t in _flat(tensors).items() if isinstance(t, torch.Tensor))


def rank_bytes(bundle: StepBundle) -> Dict[str, int]:
    """The bytes one rank stores of ``bundle``'s parameters, optimizer state
    (train) and caches (decode), as its specs place them."""
    sizes = dict(bundle.mesh)
    meta = dict(bundle.model.named_parameters())
    out = {"params": _stored(meta, bundle.pspecs, sizes)}
    if bundle.shape.mode == "train":
        out["opt_state"] = _stored(bundle.opt.init(meta), bundle.ospecs, sizes)
    if bundle.shape.mode == "decode":
        cache = bundle.model.init_cache(bundle.shape.global_batch, bundle.shape.seq_len,
                                        torch.bfloat16)
        stacked = stacked_cache(cache, lambda leaves: torch.empty(
            (len(leaves),) + tuple(leaves[0].shape), dtype=leaves[0].dtype, device="meta"))
        out["caches"] = _stored(stacked, bundle.cspecs, sizes)
    return out


def unit_bytes(bundle: StepBundle, dtype: Optional[torch.dtype] = None) -> Tuple[int, int]:
    """``(outer, largest)``: the bytes of the leaves outside every unit
    (``bundle.outer``: the embedding, the unembedding, the final norms) and
    of the largest unit (``bundle.units``), as the train step gathers a
    parameter (``StepBundle._gather_leaf``): whole, but an expert that the
    MoE's mesh forms take as this rank's block cut over ``'model'``
    (``gspecs``); in ``cfg.gather_dtype`` (leaves of two or more dims,
    stacked; the others in their own dtype), or every leaf in ``dtype``."""
    sizes = axis_sizes(bundle.mesh)
    gdt = getattr(torch, bundle.cfg.gather_dtype)
    nbytes = {}
    for n, t in bundle.model.named_parameters():
        spec = Spec(tuple(a for a in _axes(e) if a not in _axes(g))  # the axes not gathered
                    for e, g in zip(bundle.pspecs[n], bundle.gspecs[n]))
        dt = dtype or (gdt if t.ndim + bundle._stacked[n] >= 2 else t.dtype)
        nbytes[n] = math.prod(local_shape(t.shape, spec, sizes)) * dt.itemsize
    return (sum(nbytes[n] for n in bundle.outer),
            max((sum(nbytes[n] for n in names) for names in bundle.units.values()), default=0))


def update_bytes(bundle: StepBundle) -> Dict[str, int]:
    """What one rank holds for a train step's sharded update, by term
    (``StepBundle.train_step``), activations not counted: ``gathered``,
    the parameters the forward and the backward run on, gathered a unit
    at a time (``unit_bytes``: the leaves outside every unit for the whole
    step, and two of the largest units, the one running and the one
    gathered next); ``full_grads``, the float32 gradients of the same
    leaves whole, before their reduce-scatter; and this rank's shards of
    the ``masters``, the float32 ``grads`` and the optimizer ``state``."""
    sizes = dict(bundle.mesh)
    meta = dict(bundle.model.named_parameters())
    outer, unit = unit_bytes(bundle)
    outer32, unit32 = unit_bytes(bundle, torch.float32)
    f32 = {n: t.to(torch.float32) for n, t in meta.items()}
    return {"gathered": outer + 2 * unit,
            "full_grads": outer32 + 2 * unit32,
            "masters": _stored(meta, bundle.pspecs, sizes),
            "grads": _stored(f32, bundle.pspecs, sizes),
            "state": _stored(bundle.opt.init(meta), bundle.ospecs, sizes)}


@functools.lru_cache(maxsize=None)
def step_flops(cfg: ArchConfig, shape: ShapeCfg):
    """``(FLOPs by op, bytes)`` of one step of ``shape`` over the global
    batch, on ``meta`` tensors (``roofline.trace_cost.flop_count``); the
    same on every mesh, so counted once a cell.  To train, one
    microbatch's loss and gradients times the microbatches: they run the
    same operations on the same shapes."""
    from ..models.model import Model

    model = Model(cfg, device="meta")
    nmb = shape.microbatches if shape.mode == "train" else 1
    batch = {k: (torch.zeros(s, dtype=torch.long, device="meta") if k in ("tokens", "pos")
                 else torch.empty(s, device="meta"))
             for k, s in input_shapes(cfg, shape).items()}
    if shape.mode == "train":
        params = list(model.requires_grad_(True).parameters())
        mb = {k: v[:v.shape[0] // nmb] for k, v in batch.items()}

        def step():
            loss, _ = model.loss(mb)
            torch.autograd.grad(loss, params)

    elif shape.mode == "prefill":
        def step():
            model.prefill(batch)
    else:
        caches = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16)

        def step():
            model.decode(caches, batch)

    _, flops, moved = flop_count(step)
    return {op: n * nmb for op, n in flops.items()}, moved * nmb


def _active_params(cfg: ArchConfig, params: int) -> int:
    """The reference's active parameters a token: the routed experts but
    ``top_k`` of them taken out."""
    if cfg.moe is None:
        return params
    layers = list(cfg.prefix_spec) + list(cfg.period) * cfg.n_periods
    moe_layers = sum(s.ffn == "moe" for s in layers)
    per_expert = 3 * cfg.d_model * cfg.moe.expert_ff
    return params - moe_layers * (cfg.moe.n_experts - cfg.moe.top_k) * per_expert


def run_cell(arch: str, shape_name: str, mesh_name: str, outdir: Optional[str],
             overrides: Optional[dict] = None) -> dict:
    """One cell's record, written to ``<outdir>/<mesh>/`` (unless
    ``outdir`` is None) and returned; ``status`` is ``ok``, ``skip`` or
    ``error``."""
    cfg = config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "mode": shape.mode,
           "status": "ok", "overrides": {k: str(v) for k, v in (overrides or {}).items()}}
    skip = cell_skip_reason(cfg, shape_name)
    if skip:
        rec.update(status="skip", reason=skip)
        print(f"[SKIP] {arch} x {shape_name}: {skip}")
        return _write(outdir, rec, overrides)
    t0 = time.perf_counter()
    try:
        sizes = MESHES[mesh_name]
        bundle = StepBundle(cfg, sizes, shape)
        stored = rank_bytes(bundle)
        if shape.mode == "train":
            rec["update_bytes"] = update_bytes(bundle)
        flops, moved = step_flops(cfg, bundle.shape)
        params = sum(p.numel() for p in bundle.model.parameters())
        rec.update(
            seconds=round(time.perf_counter() - t0, 1),
            n_chips=math.prod(sizes.values()),
            model_axis=sizes["model"],
            bytes_per_rank=stored,
            flops=float(sum(flops.values())),
            flops_by_op=flops,
            bytes_accessed=float(moved),
            collectives={"per_kind": {}, "wire_bytes_per_chip": 0.0},
            params=params,
            params_active=_active_params(cfg, params),
            tokens=shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1),
            attention_schedule=cfg.attention_schedule,
            remat=cfg.remat,
            microbatches=bundle.shape.microbatches if shape.mode == "train" else 1,
        )
        rec["roofline"] = roofline_terms(rec)
        print(f"[OK] {arch} x {shape_name} ({mesh_name}): {rec['seconds']:.1f}s  "
              f"flops {rec['flops']:.3g}  bytes/rank {stored}"
              + (f"  update {rec['update_bytes']}" if "update_bytes" in rec else ""))
    except Exception as e:  # noqa: BLE001 - the sweep records a failed cell and goes on
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[ERR] {arch} x {shape_name} ({mesh_name}): {e}")
    return _write(outdir, rec, overrides)


def _write(outdir: Optional[str], rec: dict, overrides=None) -> dict:
    if outdir is None:
        return rec
    d = os.path.join(outdir, rec["mesh"])
    os.makedirs(d, exist_ok=True)
    tag = ""
    if overrides:
        tag = "__" + "_".join(f"{k}={v}" for k, v in sorted(overrides.items()))
        tag = tag.replace("/", "-")[:80]
    with open(os.path.join(d, f"{rec['arch']}__{rec['shape']}{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    """Run the cells the arguments name; 1 if any failed, else 0."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) pod/data/model mesh only")
    ap.add_argument("--all", action="store_true",
                    help="every architecture and shape, on both meshes unless --multi-pod")
    ap.add_argument("--outdir", default="experiments/dryrun")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. attention_schedule=bb)")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = int(v) if v.lstrip("-").isdigit() else v
    meshes = ["pod2x16x16"] if args.multi_pod else list(MESHES)
    if args.all:
        cells = [(a, s, m) for m in meshes for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, meshes[0] if args.multi_pod else "pod16x16")]
    else:
        ap.error("give --arch and --shape, or --all")
    recs = [run_cell(a, s, m, args.outdir, overrides or None) for a, s, m in cells]
    failed = [f"{r['arch']} x {r['shape']} ({r['mesh']})" for r in recs
              if r["status"] == "error"]
    print(f"{len(recs)} cells: {sum(r['status'] == 'ok' for r in recs)} ok, "
          f"{sum(r['status'] == 'skip' for r in recs)} skipped, {len(failed)} failed"
          + (f": {', '.join(failed)}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
