"""The step bundle: one cell's mesh, partition specs and step functions.

The port's counterpart of the JAX package's ``launch/steps.py``, as
explicit SPMD over ``torch.distributed``: every rank runs the step on its
own rows.  The bundle keeps one representation of the sharding, its
``Spec`` trees (``distributed/sharding.py``); the steps work on this
rank's local blocks, and parameters, optimizer state and caches cross the
API as ``DTensor``s with the specs' placements.

* ``train_step``: ZeRO-3, as the reference's ``jit_train`` places its
  step, one unit at a time, as the reference's scan gathers each period
  inside its body.  A unit (``models.model.unit_of``) is a period of the
  stack, a prefix block, a period of the encoder or the MTP head; the
  embedding, the unembedding and the final norms are gathered for each
  use (a lookup, a product, a norm).  Just before a unit runs, each rank
  casts its shard of the unit's masters to ``cfg.gather_dtype`` (leaves of
  two or more dims, stacked) and all-gathers the cast shards
  (``_Gather``), so the gather moves ``gather_dtype`` bytes; the unit's
  parameters are freed when it ends.  The experts that the MoE's TP and EP forms cut over ``'model'``
  are gathered over the other axes only, and the forms take them as this
  rank's block (``MoE.blocks``), as the reference's ``shard_map`` does.  The backward gathers a unit's leaves again where it needs them
  (``saved_tensors_hooks``: autograd keeps a handle of a gathered tensor,
  or of a copy of one cast by ``Tensor.to``, not the tensor; under remat
  the recompute gathers them), and each
  leaf's gradient is cut to this rank's shard as soon as its unit's
  backward ends: where the batch is split over the data axes it is summed
  over them (a reduce-scatter along each dim they shard, an all-reduce
  over the others) and divided by their size; a cut over ``'model'`` is a
  local slice.  The loss and its gradients run on this rank's rows, over
  ``shape.microbatches`` equal slices of them (``launch/train.py``'s
  loop, float32 accumulation of the shards' gradients).  The optimizer
  updates the shards of the masters and the state in place
  (``optim/optimizer.py``), with its global norm and Adafactor's means
  and RMS summed over the axes that shard each leaf (``_sums``).  No rank
  holds a full sharded leaf of the masters or the state, nor whole
  parameters and gradients beyond two units' and the leaves outside
  them (``launch/dryrun.unit_bytes``).  ``loss_and_grads`` gathers every
  leaf whole (the plain version).
* ``prefill_step`` and ``serve_step``: the weights (resident, sharded over
  ``'model'`` only, with ``cfg.weights_resident_serve``) are gathered a
  unit at a time, as the train step gathers them, and the model runs on
  this rank's rows.  The caches are stored in the
  reference's layout, stacked over the periods (``stacked_cache``), with
  ``cache_specs``' placements: where the period count divides the data
  axes, a data rank stores only its periods, as the reference's does.
  The decode fetches each period's cache for the layer that reads it
  from the rank that stores it, and frees it after; each period's new
  caches are stored as soon as it has run.  ``serve_step`` hands back a
  cache leaf that the decode passes through unchanged (the prefill's
  keys and values) as the caller's own ``DTensor``, so a token wraps
  only what it made.  ``serve_graph`` is the compiled ``serve_step``, as
  the reference's ``lower_serve`` jits it: one step captured as a CUDA
  graph with the parameters and caches bound, then replayed.

Inside the model the causal attention and the MoE FFN take their mesh
forms (``models/attention.py``, ``models/moe.py``).  A gather over axes
of one rank in all is no copy: on a one-rank mesh the gathered tensors
are the stored ones.  The reference's ``lower_*`` methods are its
dry run's; the port's dry run (``launch/dryrun.py``) reads a cell from
the bundle's specs on an ``{axis: size}`` mapping and from the model on
``meta`` tensors instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Any, Dict, Iterator, Optional

import torch
from torch.overrides import TorchFunctionMode

from ..configs.base import ArchConfig, ShapeCfg
from ..distributed.collectives import (all_reduce, axis_coords, axis_sizes, broadcast_from,
                                      gather_dim, group_size, reduce_scatter)
from ..distributed.sharding import (Spec, _axes, _stacked_specs, batch_specs, cache_specs,
                                    dp_axes, drop_fsdp, gather_tensor, leaf_at, local_block,
                                    local_shape, map_specs, opt_state_specs, param_specs,
                                    shard_tensor, stacked_cache)
from ..models.convert import is_stacked, stacked_groups
from ..models.model import Model, unit_of
from ..models.moe import MoE, experts_split, moe_form
from ..optim.optimizer import make_optimizer, warmup_cosine
from .graphs import StepGraph
from .train import _loss_grads_metrics

__all__ = ["StepBundle", "build", "input_shapes"]

# The dim of each expert leaf that the MoE's mesh forms cut over 'model'.
_FORM_DIMS = {"tp": {"w1": 2, "w3": 2, "w2": 1}, "ep": {"w1": 0, "w3": 0, "w2": 0}}


def input_shapes(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, tuple]:
    """The global shape of every model input of a cell, as the reference's
    ``Model.input_specs``: ``tokens`` (B, S+1) to train, (B, S) to prefill,
    (B, 1) with ``pos`` (B,) to decode; ``patches`` (B, n_patches, d) and
    ``src_embeds`` (B, S, d) where the config takes them.

    Example:
        >>> from repro_torch.configs.yi_6b import reduced
        >>> input_shapes(reduced(), ShapeCfg("t", 32, 4, "train"))
        {'tokens': (4, 33)}
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        batch = {"tokens": (b, s + 1)}
    elif shape.mode == "prefill":
        batch = {"tokens": (b, s)}
    else:
        batch = {"tokens": (b, 1), "pos": (b,)}
    if cfg.n_patches and shape.mode != "decode":
        batch["tokens"] = (b, batch["tokens"][1] - cfg.n_patches)
        batch["patches"] = (b, cfg.n_patches, cfg.d_model)
    if cfg.encoder_layers and shape.mode != "decode":
        batch["src_embeds"] = (b, s, cfg.d_model)
    return batch


def _with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its parallel spec tree."""
    if isinstance(specs, Spec):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _with_specs(fn, tree[k], v) for k, v in specs.items()}
    return type(specs)(_with_specs(fn, t, v) for t, v in zip(tree, specs))


class StepBundle:
    """One cell: the config, the mesh, the shape, the specs and the steps.

    Args:
        cfg: The architecture (its ``tp_size``, ``gather_dtype``,
            ``moe_impl``, ``microbatches_override``,
            ``weights_resident_serve``).
        mesh: A ``DeviceMesh`` with named axes (``launch/mesh.py``).
        shape: The cell's ``ShapeCfg``; ``mode`` picks train or serve
            storage.

    Attributes:
        pspecs: ``{parameter name: Spec}`` (serve specs drop ``pod`` and
            ``data`` with ``weights_resident_serve``).
        ospecs: The optimizer state's spec tree (train).
        leaf_specs: ``{reference leaf key: Spec}`` of the stacked leaves
            the optimizer updates (train).
        bspecs: ``{input: Spec}``.
        cache_shapes: The decode cache's global shapes in the stacked
            layout (decode).
        cspecs: Their spec tree (decode).
        units: ``{unit: [parameter name]}`` (``models.model.unit_of``);
            ``outer`` the leaves outside every unit.
        split: The experts' leaves that the MoE's mesh forms cut over
            ``'model'``; ``blocks`` whether the forms take them as this
            rank's block (their specs cut them over ``'model'`` where the
            form does).
        gspecs: ``{parameter name: Spec}`` the steps gather each leaf
            over: ``pspecs``, ``'model'`` dropped for the experts taken as
            blocks.

    ``sharding.named(mesh, spec)`` gives a spec's DTensor placements.
    """

    def __init__(self, cfg: ArchConfig, mesh, shape: ShapeCfg):
        if cfg.microbatches_override and shape.mode == "train":
            shape = dataclasses.replace(shape, microbatches=cfg.microbatches_override)
        self.cfg, self.mesh, self.shape = cfg, mesh, shape
        self.tp = cfg.tp_size > 1
        self.moe_ep = bool(cfg.moe) and (cfg.moe_impl or cfg.moe.impl) == "ep"
        self.dp = dp_axes(mesh, self.tp)
        self.model = Model(cfg, device="meta")  # parameters are bound per call
        meta = dict(self.model.named_parameters())
        self._owners = {}
        for n in meta:
            owner, _, leaf = n.rpartition(".")
            self._owners[n] = (self.model.get_submodule(owner) if owner else self.model, leaf)
        self._stacked = {n: is_stacked(k) for k, ms in stacked_groups(meta).items() for n in ms}
        self._cache_specs: Dict[tuple, Spec] = {}
        self._layouts: Dict[tuple, _Layout] = {}
        raw = param_specs(meta, mesh, self.tp, self.moe_ep)
        if shape.mode != "train" and cfg.weights_resident_serve:
            self.pspecs = {n: drop_fsdp(s) for n, s in raw.items()}
        else:
            self.pspecs = raw
        if shape.mode == "train":
            self.opt = make_optimizer(cfg.optimizer, warmup_cosine(3e-4, 2000, 100_000))
            self.opt_shapes = map_specs(lambda _, t: tuple(t.shape), self.opt.init(meta))
            self.ospecs = opt_state_specs(self.opt_shapes, raw, meta, mesh)
            shapes = {n: tuple(t.shape) for n, t in meta.items()}
            self.leaf_specs = {".".join(k): spec for k, (_, spec)
                               in _stacked_specs(raw, shapes).items()}
        self.batch_shapes = input_shapes(cfg, shape)
        self.bspecs = batch_specs(self.batch_shapes, mesh, self.tp)
        self.rows_split = self.bspecs["tokens"][0] is not None
        self.ndp = group_size(mesh, self.dp)
        self._reduce = self.rows_split and self.ndp > 1  # gradients summed over dp
        if shape.mode == "decode":
            cache = self.model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16)
            self.cache_shapes = stacked_cache(map_specs(lambda _, t: tuple(t.shape), cache))
            self.cspecs = cache_specs(self.cache_shapes, mesh, self.tp)
        # the experts' leaves whose gradients are partial over 'model' when
        # they are gathered whole, in one order on every rank (their
        # reduction is a collective per leaf)
        self.split = [n for n, t in meta.items() if t.ndim == 3 and experts_split(cfg, mesh)
                      and n.split(".")[-2:] in (["ffn", "w1"], ["ffn", "w3"], ["ffn", "w2"])]
        # the units' parameters, and the leaves outside every unit
        self.units: Dict[str, list] = {}
        for n in meta:
            if unit_of(n) is not None:
                self.units.setdefault(unit_of(n), []).append(n)
        self.outer = [n for n in meta if unit_of(n) is None]
        # the forms take the experts as this rank's block where their specs
        # cut them over 'model' on the dim the form cuts; then they are
        # gathered over the other axes only (``gspecs``)
        dims = _FORM_DIMS.get(moe_form(cfg, mesh) if cfg.moe else "local", {})
        self.blocks = bool(self.split) and all(
            "model" in _axes(self.pspecs[n][dims[n.rsplit(".", 1)[1]]]) for n in self.split)
        self.gspecs = {n: (Spec(tuple(a for a in _axes(e) if a != "model") for e in spec)
                           if self.blocks and n in self.split else spec)
                       for n, spec in self.pspecs.items()}
        self._moes = [m for m in self.model.modules() if isinstance(m, MoE)]
        self._gdt = getattr(torch, cfg.gather_dtype)

    # ------------------------------------------------------------ storage

    def shard_params(self, params) -> Dict[str, Any]:
        """Every parameter as a ``DTensor`` with ``pspecs``' placements.

        Args:
            params: A ``Model`` or ``{name: tensor}``, the full tensors, the
                same on every rank.  Each shard is a view of its tensor (on
                one rank, the tensor itself).
        """
        if isinstance(params, torch.nn.Module):
            params = dict(params.named_parameters())
        return {n: shard_tensor(params[n].detach(), self.mesh, s)
                for n, s in self.pspecs.items()}

    def init_opt_state(self, params=None):
        """The optimizer's zero state as ``DTensor``s with ``ospecs``'
        placements, each rank allocating only its shard on the mesh's
        device (``params`` is not read: the state starts at zero)."""
        del params
        device = self._device()

        def zeros(shape, spec):
            local = torch.zeros(local_shape(shape, spec, self.mesh), dtype=torch.float32,
                                device=device)
            return shard_tensor(local, self.mesh, spec, presharded=range(len(shape)))

        return _with_specs(zeros, self.opt_shapes, self.ospecs)

    def shard_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """The global batch (the same on every rank) as ``DTensor``s with
        ``bspecs``' placements."""
        return {k: shard_tensor(v, self.mesh, self.bspecs[k]) for k, v in batch.items()}

    # --------------------------------------------------------------- train

    def gather_params(self, params) -> Dict[str, torch.Tensor]:
        """The full parameters (``param_dtype``) on every rank."""
        return {n: gather_tensor(t, self.mesh, self.pspecs[n]) for n, t in params.items()}

    def loss_and_grads(self, params, batch):
        """``(loss, grads)`` of this step's rows, as ``train_step``
        computes them, on every parameter gathered whole before the
        forward (the plain version of the step's per-unit gathers): the
        loss averaged over the microbatches and the data shards, the
        gradients float32 and reduced over the data axes whole (every rank
        gets the same full gradients)."""
        leaves = {n: self._gather_leaf(t.to_local() if hasattr(t, "to_local") else t, n,
                                       self.pspecs[n]).detach().requires_grad_(True)
                  for n, t in params.items()}
        with self._bound(leaves):
            loss, grads, _ = _loss_grads_metrics(self.model, self._rows(batch),
                                                 self.shape.microbatches, self.mesh)
        del leaves
        if group_size(self.mesh, "model") > 1:
            for n in self.split:  # each rank computed its slice of the experts
                all_reduce(grads[n], self.mesh, "model")
        if self._reduce:
            for g in grads.values():
                all_reduce(g, self.mesh, self.dp).div_(self.ndp)
        return self._mean_loss(loss), grads

    def _grads(self, params, batch):
        """The loss of this step's rows and this rank's float32 shard of
        every gradient, each unit's parameters gathered just before it runs
        (``_Step``) and each leaf's gradient cut to the shard as soon as its
        unit's backward ends (``_leaf_grad``): the loss averaged over the
        microbatches and the data shards."""
        step = _Step(self, params, grad=True)
        with step.running():
            loss, grads, _ = _loss_grads_metrics(self.model, self._rows(batch),
                                                 self.shape.microbatches, self.mesh,
                                                 leaves=step.shards, bind=step)
        return self._mean_loss(loss), grads

    def _mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """This rank's loss averaged over the data shards."""
        if self._reduce:
            loss = all_reduce(loss.reshape(1).clone(), self.mesh, self.dp)[0] / self.ndp
        return loss

    def _gather_leaf(self, shard: torch.Tensor, name: str,
                     spec: Optional[Spec] = None) -> torch.Tensor:
        """Parameter ``name`` as a unit runs on it: this rank's ``shard``
        cast to ``gather_dtype`` (leaves of two or more dims, stacked) and
        gathered over the axes of ``spec``, by default its ``gspecs`` entry
        (on axes of one rank in all, no copy)."""
        if shard.ndim + self._stacked[name] >= 2:
            shard = shard.to(self._gdt)
        return gather_tensor(shard, self.mesh, self.gspecs[name] if spec is None else spec)

    def _leaf_grad(self, g: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's float32 shard of the gradient ``g`` of
        ``_gather_leaf``'s result: an expert gathered whole while the forms
        cut it over ``'model'`` is summed there first (each rank computed
        its slice), then ``_grad_shard``."""
        g = g.to(torch.float32)
        if name in self.split and not self.blocks and group_size(self.mesh, "model") > 1:
            g = all_reduce(g.clone(memory_format=torch.contiguous_format), self.mesh, "model")
        return self._grad_shard(g, self.gspecs[name])

    def train_step(self, params, opt_state, step, batch):
        """One optimizer step on this rank's shards.

        Args:
            params: ``{name: DTensor}`` (``shard_params``), the float32
                masters; updated in place.
            opt_state: The state tree of ``DTensor``s (``init_opt_state``);
                updated in place.
            step: The step number (an int or a scalar tensor).
            batch: ``{input: DTensor}`` (``shard_batch``), or the global
                batch (the same on every rank), whose rows this rank takes.

        Returns:
            ``(params, opt_state, step + 1, {"loss": loss})``: the same
            ``DTensor``s with the new shards written into them (the
            reference donates them), and the loss the mean over every row
            of the batch.  ``opt_state["gnorm"]`` is the global gradient
            norm, the same on every rank.
        """
        loss, mine = self._grads(params, batch)
        state = _with_specs(lambda dt, _: dt.to_local(), opt_state, self.ospecs)
        self.opt.update(mine, state, {n: t.to_local() for n, t in params.items()}, step,
                        sums=self._sums)
        return params, opt_state, step + 1, {"loss": loss}

    def _grad_shard(self, g: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's shard under ``spec`` of a full gradient (not
        written): where the rows are split over the data axes, summed over
        them (a reduce-scatter along each dim they shard, in
        ``local_block``'s order, the outer axis first; an all-reduce over
        the others) and divided by their size; a cut over another axis is a
        local slice, copied out so that the full gradient can be freed."""
        sizes, coords = axis_sizes(self.mesh), axis_coords(self.mesh)
        summed, cut, own = set(), False, False
        for d, entry in enumerate(spec):
            for a in _axes(entry):
                if sizes[a] == 1:
                    continue
                if self._reduce and a in self.dp:
                    g, own = reduce_scatter(g, self.mesh, a, d), True
                    summed.add(a)
                else:
                    n = g.shape[d] // sizes[a]
                    g, cut = g.narrow(d, coords[a] * n, n), True
        if cut:
            g, own = g.clone(memory_format=torch.contiguous_format), True
        if self._reduce:
            rest = [a for a in self.dp if a not in summed and sizes[a] > 1]
            if rest:
                g = g.contiguous() if own else g.clone(memory_format=torch.contiguous_format)
                g, own = all_reduce(g, self.mesh, rest), True
            g = g.div_(self.ndp) if own else g / self.ndp
        return g

    def _sums(self, parts):
        """The optimizer's ``sums`` hook (``optim.optimizer.Sums``): each
        leaf's partial result summed over the mesh axes of more than one
        rank that shard the dims it reduced (``leaf_specs``), and only
        those, so no replicated copy counts twice; one all-reduce for each
        set of axes."""
        sizes = axis_sizes(self.mesh)
        groups: Dict[tuple, list] = {}
        for i, (key, _, dims) in enumerate(parts):
            spec = self.leaf_specs[key]
            cut = {a for d in dims for a in _axes(spec[d]) if sizes[a] > 1}
            groups.setdefault(tuple(a for a in sizes if a in cut), []).append(i)
        out = [None] * len(parts)
        for axes, idx in groups.items():
            xs = [parts[i][1] for i in idx]
            if axes:
                flat = all_reduce(torch.cat([x.reshape(-1) for x in xs]), self.mesh, axes)
                xs = [y.view_as(x) for y, x in zip(flat.split([x.numel() for x in xs]), xs)]
            ranks = math.prod(sizes[a] for a in axes)
            for i, x in zip(idx, xs):
                out[i] = (x, ranks)
        return out

    # ----------------------------------------------------------- serving

    def prefill_step(self, params, batch):
        """Full-sequence forward on this rank's rows.

        Returns:
            ``(last_logits, caches)``: ``(B, 1, vocab)`` logits as a
            ``DTensor`` split over the data axes like the batch, and the
            caches in the reference's layout (``stacked_cache``):
            ``caches["stack"]`` one ``DTensor`` a leaf, stacked over the
            periods, of which each rank stores the periods ``cache_specs``
            gives it; ``caches["prefix"]`` as the model's, a ``DTensor`` a
            leaf.  Each period's caches are stored as soon as it has run.
        """
        store = _Periods(self)
        step = _Step(self, params, grad=False)
        with step.running():
            logits, caches = self.model.prefill(self._rows(batch), self.mesh, keep=store.keep,
                                                bind=step)
        return self._rows_out(logits), self._caches_out(caches, store, {}, {})

    def serve_step(self, params, caches, batch):
        """One decoded token against ``caches`` (``prefill_step``'s): each
        layer runs against its period's cache, fetched from the rank that
        stores it and gathered over ``'model'`` for this rank's rows, then
        freed (the fetch GSPMD makes for a scan over a sharded period
        axis); the prefix caches are gathered over every axis but the
        rows'.  ``Model.decode`` runs on this rank's rows.

        Returns:
            ``(logits, new_caches)`` as ``prefill_step`` returns them; a
            leaf of ``new_caches`` that the decode passed through unchanged
            is the ``DTensor`` of ``caches`` it came from.
        """
        given = {}

        def rows(_, dt):
            spec = self._cache_spec(tuple(dt.shape))
            local = gather_tensor(dt, self.mesh, Spec((None,) + tuple(spec[1:])))
            given[id(local)] = dt
            return local

        store = _Periods(self, caches["stack"])
        local = {"stack": store}
        if "prefix" in caches:
            local["prefix"] = map_specs(rows, caches["prefix"])
        step = _Step(self, params, grad=False)
        with step.running():
            logits, new = self.model.decode(local, self._rows(batch), self.mesh,
                                            keep=store.keep, bind=step)
        return self._rows_out(logits), self._caches_out(new, store, caches, given)

    def serve_graph(self, params, caches, batch):
        """The compiled ``serve_step``, as the reference jits it: one
        ``serve_step(params, caches, batch)`` captured as a CUDA graph
        (``launch/graphs.StepGraph``) with ``params`` and ``caches`` bound.

        Args:
            params: ``shard_params``' ``DTensor``s, kept alive and in place
                while the step is used.
            caches: ``prefill_step``'s caches, likewise.
            batch: An example ``{"tokens": (B, 1), "pos": (B,)}`` of global
                tensors on the card (the same on every rank); its shapes
                are fixed.

        Returns:
            ``step(batch) -> (logits, new_caches)`` as ``serve_step``
            returns them: ``DTensor``s made once at capture around the
            graph's static outputs, which the next call overwrites (a leaf
            passed through unchanged is the caller's own).
        """
        return StepGraph(lambda b: self.serve_step(params, caches, b), batch)

    # ------------------------------------------------------------ helpers

    @contextlib.contextmanager
    def _bound(self, tensors: Dict[str, torch.Tensor]) -> Iterator[None]:
        """The bundle's model with its parameters replaced by ``tensors``
        (by name) for the block."""
        saved = []
        for name, t in tensors.items():
            mod, leaf = self._owners[name]
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        try:
            yield
        finally:
            for mod, leaf, p in saved:
                mod._parameters[leaf] = p

    def _device(self) -> torch.device:
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def _keep(self, full: torch.Tensor, spec: Spec, presharded=()):
        """This rank's shard of a result, copied out of ``full`` (unless it
        is all of it) so that ``full`` can be freed."""
        return shard_tensor(full, self.mesh, spec, presharded, copy=True)

    def _rows(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of every input: a ``DTensor``'s local shard, or
        the rank's block of a global tensor."""
        return {k: (v.to_local() if hasattr(v, "to_local")
                    else local_block(v, self.mesh, self.bspecs[k]))
                for k, v in batch.items()}

    def _rows_out(self, x: torch.Tensor):
        spec = Spec(((self.dp if self.rows_split else None),) + (None,) * (x.ndim - 1))
        return shard_tensor(x, self.mesh, spec, presharded=(0,))

    def _cache_spec(self, shape: tuple) -> Spec:
        """``cache_specs``' spec of a cache leaf of global ``shape`` (a
        stacked leaf's shape has the periods first)."""
        if shape not in self._cache_specs:
            self._cache_specs[shape] = cache_specs({"c": shape}, self.mesh, self.tp)["c"]
        return self._cache_specs[shape]

    def _layout(self, shape: tuple) -> "_Layout":
        """The ``_Layout`` of a stacked cache leaf of global ``shape``,
        worked out once a shape: the mesh and the specs do not change."""
        if shape not in self._layouts:
            spec = self._cache_spec(shape)
            sizes, coords = axis_sizes(self.mesh), axis_coords(self.mesh)
            axes, n, mine = _axes(spec[0]), 1, 0
            for a in axes:
                n, mine = n * sizes[a], mine * sizes[a] + coords[a]
            split = any(sizes[a] > 1 for e in spec[1:] for a in _axes(e))
            self._layouts[shape] = _Layout(spec, Spec(spec[1:]), axes, shape[0] // n, mine,
                                           n > 1, split)
        return self._layouts[shape]

    def _cache_out(self, t: torch.Tensor):
        """A cache leaf of this rank's rows as a ``DTensor``."""
        ndp = self.ndp if self.rows_split else 1
        spec = self._cache_spec((t.shape[0] * ndp,) + tuple(t.shape[1:]))
        return self._keep(t, spec, (0,))

    def _caches_out(self, new, store: "_Periods", caches, given):
        """The decode's or prefill's caches as ``DTensor``s: the stacked
        leaves from ``store``, a leaf passed through unchanged as the
        caller's own."""
        def stacked(path, _):
            if store.passed[path] is not None:
                return leaf_at(caches["stack"], store.passed[path])
            local, spec = store.slots[path]
            return shard_tensor(local, self.mesh, spec, presharded=range(local.ndim))

        out = {"stack": map_specs(stacked, new["stack"][0])}
        if "prefix" in new:
            out["prefix"] = map_specs(
                lambda _, t: given[id(t)] if id(t) in given else self._cache_out(t),
                new["prefix"])
        return out


class _Gather(torch.autograd.Function):
    """This rank's float32 shard of a parameter -> the tensor its unit runs
    on (``StepBundle._gather_leaf``); the backward is
    ``StepBundle._leaf_grad``, this rank's float32 shard of the
    gradient.  The shard is the autograd leaf, so no ``AccumulateGrad``
    holds the gathered tensor."""

    @staticmethod
    def forward(ctx, shard, bundle, name):
        ctx.bundle, ctx.name = bundle, name
        return bundle._gather_leaf(shard, name)

    @staticmethod
    def backward(ctx, g):
        return ctx.bundle._leaf_grad(g, ctx.name), None, None


@dataclasses.dataclass(frozen=True)
class _Handle:
    """What autograd keeps of a tensor made from a gathered parameter:
    how to make it again (``recipe``), and its size, stride and storage
    offset beside the tensor that ``recipe`` makes."""

    recipe: tuple
    size: tuple
    stride: tuple
    offset: int


class _Casts(TorchFunctionMode):
    """Records each ``Tensor.to`` copy of a tensor that ``step`` made from
    a gathered parameter (a weight cast to the activations' dtype), so
    that autograd keeps a handle of it too."""

    def __init__(self, step: "_Step"):
        super().__init__()
        self.step = step

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.Tensor.to and out is not args[0] and isinstance(out, torch.Tensor):
            self.step.cast(args[0], out, args[1:], kwargs)
        return out


class _Step:
    """One call's parameters, bound into the bundle's model where they
    run: the ``bind`` hook of ``Model``.

    ``shards`` are this rank's blocks of the masters (with ``grad``,
    float32 autograd leaves).  ``self(unit)`` gathers a unit's leaves, and
    ``self(name)`` a leaf outside every unit for one use (``_Gather`` with
    ``grad``, else ``StepBundle._gather_leaf``), binds them for the block
    and drops them after.  With ``grad``, ``running()`` keeps autograd
    from holding a tensor made from a gathered parameter for the backward
    (a gathered tensor, a view of one, or a ``Tensor.to`` copy of those;
    ``made`` maps their storages, by weak reference): it keeps a
    ``_Handle``, and the backward makes the tensor again where it reads
    it, gathering the leaf again, and keeps none of them.  Every rank
    packs and unpacks in the same order, so the gathers match.
    """

    def __init__(self, bundle: StepBundle, params, grad: bool):
        self.b, self.grad = bundle, grad
        self.shards = {}
        for n, t in params.items():
            local = t.to_local() if hasattr(t, "to_local") else t
            self.shards[n] = local.detach().requires_grad_(True) if grad else local
        self.made: Dict[int, tuple] = {}

    def _gather(self, name: str) -> torch.Tensor:
        if not self.grad:
            return self.b._gather_leaf(self.shards[name], name)
        t = _Gather.apply(self.shards[name], self.b, name)
        self._note(t, ("leaf", name))
        return t

    def _note(self, t: torch.Tensor, recipe: tuple) -> None:
        ptr = t.untyped_storage().data_ptr()
        if ptr:
            self.made[ptr] = (weakref.ref(t), t.storage_offset(), recipe)

    def _entry(self, t: torch.Tensor):
        entry = self.made.get(t.untyped_storage().data_ptr())
        return entry if entry is not None and entry[0]() is not None else None

    @contextlib.contextmanager
    def __call__(self, unit: str) -> Iterator[None]:
        with self.b._bound({n: self._gather(n) for n in self.b.units.get(unit, [unit])}):
            yield

    @contextlib.contextmanager
    def running(self) -> Iterator[None]:
        """The call's context: the MoE forms take the experts as blocks
        where the bundle gathers them so (``MoE.blocks``), and with
        ``grad`` autograd keeps handles."""
        for m in self.b._moes:
            m.blocks = self.b.blocks
        none = contextlib.nullcontext()
        try:
            with (torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack)
                  if self.grad else none), (_Casts(self) if self.grad else none):
                yield
        finally:
            for m in self.b._moes:
                m.blocks = False

    def cast(self, src: torch.Tensor, out: torch.Tensor, args, kwargs) -> None:
        """Note ``out = src.to(*args, **kwargs)`` where ``src`` shares a
        noted storage."""
        entry = self._entry(src)
        if entry is None or any(isinstance(a, torch.Tensor)
                                for a in (*args, *kwargs.values())):
            return
        geom = (tuple(src.size()), tuple(src.stride()), src.storage_offset() - entry[1])
        self._note(out, ("to", entry[2], geom, tuple(args), dict(kwargs)))

    def pack(self, t: torch.Tensor):
        entry = self._entry(t)
        if entry is None:
            return t
        return _Handle(entry[2], tuple(t.size()), tuple(t.stride()),
                       t.storage_offset() - entry[1])

    def unpack(self, h):
        if not isinstance(h, _Handle):
            return h
        base = self._make(h.recipe)
        return base.as_strided(h.size, h.stride, base.storage_offset() + h.offset)

    def _make(self, recipe: tuple) -> torch.Tensor:
        """The tensor ``recipe`` names, made again without autograd."""
        if recipe[0] == "to":
            _, parent, (size, stride, offset), args, kwargs = recipe
            src = self._make(parent)
            return src.as_strided(size, stride, src.storage_offset() + offset).to(*args, **kwargs)
        with torch.no_grad():
            return self.b._gather_leaf(self.shards[recipe[1]].detach(), recipe[1])


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where a stacked cache leaf lives: its spec and the spec of one
    period (``inner``), the axes of the period dim, the periods a rank
    stores (``per``), this rank's index over those axes (``mine``), and
    whether the periods (``spread``) or one period's dims (``split``) go
    over more than one rank."""

    spec: Spec
    inner: Spec
    axes: tuple
    per: int
    mine: int
    spread: bool
    split: bool


@dataclasses.dataclass
class _Stored:
    """One stacked cache leaf: its path, this rank's block, its layout."""

    path: tuple
    local: torch.Tensor
    layout: _Layout


class _Periods:
    """A bundle's stacked caches, one period at a time, for ``stack_apply``.

    ``self[k]`` is period ``k``'s caches for this rank's rows: the block of
    the rank that stores the period (broadcast over the axes of the
    stacked spec's dim 0), gathered over ``'model'``.  ``keep(k, caches)``
    stores a period's new caches as ``cache_specs`` places the stacked
    leaf: the rows are gathered over the data axes, and each rank copies
    the block of the periods it stores into its stacked block and drops
    the rest.  So no rank holds more than the periods it stores and one
    period besides.  A leaf that comes back from the decode as it was
    fetched is marked passed (``passed[path]``, the input's path) and not
    stored.
    """

    def __init__(self, bundle: StepBundle, stored=None):
        self.b, self.given = bundle, {}
        self.slots: Dict[tuple, tuple] = {}
        self.passed: Dict[tuple, Any] = {}
        self.layouts: Dict[tuple, _Layout] = {}
        self.stored = map_specs(
            lambda path, dt: _Stored(path, dt.to_local(), bundle._layout(tuple(dt.shape))),
            stored or {})

    def __len__(self) -> int:
        return self.b.cfg.n_periods

    def __getitem__(self, k: int):
        b = self.b
        self.given = {}

        def fetch(_, leaf: _Stored):
            lay = leaf.layout
            owner, i = divmod(k, lay.per)
            if owner == lay.mine:
                x = leaf.local[i]
            else:
                x = torch.empty(leaf.local.shape[1:], dtype=leaf.local.dtype,
                                device=leaf.local.device)
            if lay.spread:
                x = broadcast_from(x, b.mesh, lay.axes, owner)
            full = gather_tensor(x, b.mesh, lay.inner) if lay.split else x
            if b.rows_split and b.ndp > 1:
                full = local_block(full, b.mesh, Spec((b.dp,) + (None,) * (full.ndim - 1)))
            self.given[id(full)] = leaf.path
            return full

        return map_specs(fetch, self.stored)

    def keep(self, k: int, caches):
        """Store period ``k``'s new caches (this rank's rows); returns
        their tree with ``None`` leaves."""
        b = self.b

        def one(path, t):
            came = self.given.get(id(t))
            if self.passed.setdefault(path, came) != came:
                raise RuntimeError(f"cache leaf {path}: period {k} passes through unlike "
                                   "period 0")
            if came is not None:
                return
            if b.rows_split and b.ndp > 1:
                t = gather_dim(t, b.mesh, b.dp, 0)
            lay = self.layouts.get(path)
            if lay is None:
                lay = self.layouts[path] = b._layout((len(self),) + tuple(t.shape))
            owner, i = divmod(k, lay.per)
            if owner != lay.mine:
                return
            block = local_block(t, b.mesh, lay.inner) if lay.split else t
            if path not in self.slots:
                self.slots[path] = (torch.empty((lay.per,) + tuple(block.shape),
                                                dtype=block.dtype, device=block.device),
                                    lay.spec)
            self.slots[path][0][i].copy_(block)

        return map_specs(one, caches)


def build(cfg: ArchConfig, mesh, shape: ShapeCfg) -> StepBundle:
    """The ``StepBundle`` of one cell."""
    return StepBundle(cfg, mesh, shape)
