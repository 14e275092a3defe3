"""Partition rules: parameters, optimizer state, batches, caches.

The port's counterpart of the JAX package's ``distributed/sharding.py``.
Mesh axes: ``('pod', 'data', 'model')`` multi-pod, ``('data', 'model')``
single-pod.  ``'pod'`` and ``'data'`` form the FSDP/DP axes (``dp``);
``'model'`` is the tensor/expert-parallel axis.

Parameters follow Megatron-style column/row rules with ZeRO-3 storage:
the non-``'model'`` matrix dim shards over ``dp``.  Optimizer state
mirrors the parameters (Adafactor's factored statistics drop the reduced
dim from the spec).  Batches and caches take a divisibility rule, so every
(architecture x shape) gets a legal spec.

Every rule is a pure function of an ordered ``{axis: size}`` mapping (a
``DeviceMesh`` is read through ``mesh_dim_names`` and ``shape``) and the
leaves' shapes.  A spec is a ``Spec``: a tuple with one entry per tensor
dim, each ``None``, an axis name or a tuple of names, as a JAX
``PartitionSpec`` holds it.

The port's parameters are per period (``stack.<k>.l0.mixer.wq``); the
reference's are stacked over the periods.  A per-period tensor's spec is
the reference's stacked spec without its leading ``None``
(``models.convert.stacked_groups`` names the reference's leaf).  The
optimizer state is the reference's stacked tree, and takes the
reference's specs as they are.  The caches are placed as the reference
places its stacked caches: ``stacked_cache`` gives the reference's
layout, which the step bundle stores, and there the cache rule sees a
``stack`` leaf with the period axis as dim 0, so the periods, not the
batch, go over ``dp`` when their count divides.

``named`` turns specs into DTensor placements: a tensor dim sharded over
``('pod', 'data')`` is ``Shard(d)`` on both mesh dims, which DTensor
nests pod-major, as JAX does.  ``local_block`` cuts this rank's block out
of a full tensor, ``shard_tensor`` wraps it as a ``DTensor`` and
``gather_tensor`` gathers the full tensor back from the blocks.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..models.convert import is_stacked, stacked_groups
from .collectives import axis_coords, axis_sizes, gather_dim

__all__ = [
    "Spec",
    "dp_axes",
    "param_specs",
    "opt_state_specs",
    "batch_specs",
    "cache_specs",
    "stacked_cache",
    "leaf_at",
    "drop_fsdp",
    "named",
    "placements",
    "local_shape",
    "local_block",
    "shard_tensor",
    "gather_tensor",
    "map_specs",
]


class Spec(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name or a tuple of two or more names; a tuple of one name is held
    as the name and an empty one as ``None``, as ``PartitionSpec`` holds
    them.  A tuple, so it compares equal to ``tuple(PartitionSpec(...))``;
    a class of its own, so a tree of specs is told from the tuples of a
    cache tree.

    Example:
        >>> Spec((("data",), "model")) == ("data", "model")
        True
        >>> Spec((("pod", "data"), ()))
        Spec((('pod', 'data'), None))
    """

    def __new__(cls, dims=()):
        def norm(entry):
            if isinstance(entry, (tuple, list)):
                entry = tuple(entry)
                return None if not entry else (entry[0] if len(entry) == 1 else entry)
            return entry

        return super().__new__(cls, tuple(norm(e) for e in dims))

    def __repr__(self) -> str:
        return f"Spec({tuple(self)!r})"


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dp_axes(mesh, tp: bool = True) -> Tuple[str, ...]:
    """FSDP/DP axes.  With ``tp=False`` the ``'model'`` axis folds in.

    Example:
        >>> dp_axes({"data": 2, "model": 2}), dp_axes({"pod": 2, "data": 2, "model": 2}, False)
        (('data',), ('pod', 'data', 'model'))
    """
    names = axis_sizes(mesh)
    base = tuple(a for a in ("pod", "data") if a in names)
    return base if tp else base + ("model",)


def _detp(spec: Spec) -> Spec:
    """Replace ``'model'`` by ``None`` in a spec (tp disabled); the fsdp
    group already includes ``'model'`` through ``dp_axes(mesh, False)``."""
    dims = []
    for ax in spec:
        if ax == "model":
            dims.append(None)
        elif isinstance(ax, tuple) and "model" in ax:
            dims.append(tuple(a for a in ax if a != "model") or None)
        else:
            dims.append(ax)
    return Spec(dims)


# ---------------------------------------------------------------- params

_COL = (  # (in, out): shard out dim over 'model', in over fsdp
    "wq", "wk", "wv", "w1", "w3", "up", "in_proj", "w_uq", "up1", "up2",
    "dt_proj",
)
_ROW = ("wo", "w2", "down", "out_proj")  # shard in dim over 'model'
_DIN = ("w_dq", "w_dkv", "proj", "w_in")  # (d_model, small): fsdp on d only
_REP = ("router", "w_kr", "r", "bias", "w_gn")  # replicated


def _spec_for(path: Tuple[str, ...], nd: int, fsdp, moe_ep: bool = False) -> Spec:
    """The rule of the reference's leaf ``path`` (unstacked, ``nd`` dims)."""
    name = path[-1]
    if "ffn" in path and nd == 3:  # the experts
        if moe_ep and name in ("w1", "w3", "w2"):  # experts over 'model'
            return Spec(("model", fsdp, None))
        if name in ("w1", "w3"):
            return Spec((None, fsdp, "model"))
        if name == "w2":
            return Spec((None, "model", fsdp))
    if name == "e":  # embedding (V, D)
        return Spec(("model", None))
    if name == "unembed":
        return Spec((None, "model"))
    if name in ("w_uk", "w_uv"):  # (kv_lora, H*dim): column-parallel
        return Spec((None, "model"))
    if name in _REP:
        return Spec((None,) * nd)
    if name in _DIN and nd == 2:
        return Spec((fsdp, None))
    if name in _COL and nd == 2:
        return Spec((fsdp, "model"))
    if name in _ROW and nd == 2:
        return Spec(("model", fsdp))
    if name == "conv_w":  # (K, d_inner)
        return Spec((None, "model"))
    if name in ("conv_b", "d_skip", "dt_bias", "skip_scale") and nd == 1:
        return Spec(("model",))
    if name == "a_log":  # (d_inner, N)
        return Spec(("model", None))
    if name in ("wi", "wf") and nd == 2:  # mLSTM gates (dp, H)
        return Spec(("model", None))
    return Spec((None,) * nd)  # norms, scalars, small leftovers


def _fit_spec(spec: Spec, shape: Sequence[int], sizes: Mapping[str, int]) -> Spec:
    """Drop mesh axes from dims they do not divide (seamless's vocab
    256206 is not 16-divisible, so its embedding replicates)."""
    dims = []
    for n, entry in zip(shape, spec):
        size = math.prod(sizes[a] for a in _axes(entry))
        dims.append(entry if entry is not None and n % size == 0 else None)
    return Spec(dims)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    """``{port name: shape}`` of a model or a mapping of tensors/shapes."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {name: _shape(p) for name, p in params.items()}


def param_specs(params, mesh, tp: bool = True, moe_ep: bool = False) -> Dict[str, Spec]:
    """The spec of every parameter of the port's model.

    Args:
        params: A ``Model``, or ``{port name: tensor or shape}``
            (``stack.<k>.l0.mixer.wq`` per period).
        mesh: ``{axis: size}`` or a ``DeviceMesh``.
        tp: Whether ``'model'`` is a tensor-parallel axis; without it the
            axis folds into FSDP.
        moe_ep: Experts stored over ``'model'`` (expert parallelism).

    Returns:
        ``{port name: Spec}``; a per-period leaf takes the reference's
        stacked spec without its leading ``None``.  An axis that does not
        divide its dim falls back to replication.

    Example:
        >>> param_specs({"stack.0.l0.mixer.wq": (64, 64), "embed.e": (512, 64)},
        ...             {"data": 2, "model": 2})
        {'stack.0.l0.mixer.wq': Spec(('data', 'model')), 'embed.e': Spec(('model', None))}
    """
    sizes = axis_sizes(mesh)
    fsdp = dp_axes(sizes, tp)
    shapes = _named_shapes(params)
    out = {}
    for key, members in stacked_groups(shapes).items():
        for name in members:
            shape = shapes[name]
            base = _spec_for(tuple(key.split(".")), len(shape), fsdp, moe_ep)
            if not tp:
                base = _detp(base)
            out[name] = _fit_spec(base, shape, sizes)
    return {name: out[name] for name in shapes}


def _stacked_specs(pspecs: Mapping[str, Spec], shapes) -> Dict[Tuple[str, ...], tuple]:
    """The reference's leaf path -> (stacked shape, stacked spec)."""
    flat = {}
    for key, members in stacked_groups(shapes).items():
        spec, shape = pspecs[members[0]], shapes[members[0]]
        if is_stacked(key):
            spec, shape = Spec((None,) + tuple(spec)), (len(members),) + tuple(shape)
        flat[tuple(key.split("."))] = (tuple(shape), spec)
    return flat


def _is_shape(x) -> bool:
    """A leaf that is a shape: a ``Spec``, a ``torch.Size`` or a tuple of ints."""
    return isinstance(x, (Spec, torch.Size)) or (
        isinstance(x, tuple) and all(isinstance(n, int) for n in x))


def map_specs(fn: Callable[[Tuple[str, ...], Any], Any], tree, path: Tuple[str, ...] = ()):
    """Apply ``fn(path, leaf)`` to every tensor (or shape) leaf of a tree of dicts, lists and tuples; a dict key with dots adds one path
    entry per part.  Returns the tree of results, same structure."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, path + tuple(str(k).split("."))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_shape(tree):
        return type(tree)(map_specs(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def opt_state_specs(opt_state, pspecs: Mapping[str, Spec], params, mesh):
    """Mirror parameter specs onto the optimizer state.

    AdamW's ``m``/``v`` have the stacked parameters' shapes; Adafactor's
    ``vr`` drops the last dim and ``vc`` the second-to-last.  Dispatch by
    shape, as the reference does.

    Args:
        opt_state: The port optimizer's state tree (``{"m": {"stack.l0.mixer.wq":
            ...}, ...}``, the reference's stacked leaves).
        pspecs: ``param_specs`` of ``params``.
        params: The model's parameters, as ``param_specs`` takes them.
        mesh: Unused beyond the reference's signature.

    Returns:
        The same tree with a ``Spec`` per leaf.
    """
    del mesh
    flatp = _stacked_specs(pspecs, _named_shapes(params))

    def walk(names, leaf):
        nd = len(_shape(leaf))
        if names[-1] == "gnorm":
            return Spec()
        core, suffix = names[1:], None
        if core and core[-1] in ("vr", "vc", "v"):
            suffix = core[-1]
            if core[:-1] in flatp:
                core = core[:-1]
        if core not in flatp:
            return Spec((None,) * nd)
        p_shape, p_spec = flatp[core]
        shape = _shape(leaf)
        if shape == p_shape:
            return p_spec
        if suffix == "vr" and shape == p_shape[:-1]:
            return Spec(p_spec[:-1])
        if suffix == "vc" and shape == p_shape[:-2] + p_shape[-1:]:
            return Spec(tuple(p_spec[:-2]) + (p_spec[-1],))
        return Spec((None,) * nd)

    return map_specs(walk, opt_state)


# ----------------------------------------------------------- batch / cache


def _divisible(n: int, sizes: Mapping[str, int], axes) -> bool:
    size = math.prod(sizes[a] for a in _axes(axes))
    return n % size == 0 and n >= size


def batch_specs(batch, mesh, tp: bool = True):
    """Dim 0 of every batch leaf over ``dp`` when it divides, else
    replicated.

    Example:
        >>> batch_specs({"tokens": (8, 33), "pos": (1,)}, {"data": 2, "model": 2})
        {'tokens': Spec(('data', None)), 'pos': Spec((None,))}
    """
    sizes = axis_sizes(mesh)
    dp = dp_axes(sizes, tp)

    def walk(_, leaf):
        shape = _shape(leaf)
        if not shape:
            return Spec()
        return Spec(((dp if _divisible(shape[0], sizes, dp) else None),)
                    + (None,) * (len(shape) - 1))

    return map_specs(walk, batch)


def _cache_rule(shape, sizes: Mapping[str, int], dp, msize: int) -> Spec:
    """The reference's cache rule on one leaf of ``shape``."""
    if not shape:
        return Spec()
    dims = [None] * len(shape)
    if _divisible(shape[0], sizes, dp):
        dims[0] = dp
    best, best_size = None, 0
    if msize > 1:
        for i in range(1, len(shape)):
            if shape[i] % msize == 0 and shape[i] > best_size:
                best, best_size = i, shape[i]
    if best is not None:
        dims[best] = "model"
    return Spec(dims)


def stacked_cache(cache, fn: Callable[[list], Any] = None):
    """The reference's layout of a cache tree: ``stack``'s list of
    per-period trees as one tree whose leaves are ``fn(list of the
    periods' leaves)`` (by default the stacked shape ``(periods,) +
    shape``); the other entries as they are.

    Example:
        >>> stacked_cache({"stack": [{"k": (8, 4)}, {"k": (8, 4)}], "prefix": {"k": (8, 2)}})
        {'stack': {'k': (2, 8, 4)}, 'prefix': {'k': (8, 2)}}
    """
    fn = fn or (lambda leaves: (len(leaves),) + _shape(leaves[0]))
    periods = cache["stack"]
    out = dict(cache)
    out["stack"] = map_specs(lambda path, _: fn([leaf_at(p, path) for p in periods]),
                             periods[0])
    return out


def leaf_at(tree, path: Sequence[str]):
    """The leaf of a tree of dicts, lists and tuples at a ``map_specs``
    path (a list or tuple index as its string).

    Example:
        >>> leaf_at({"a": [(1, 2), (3, 4)]}, ("a", "1", "0"))
        3
    """
    for key in path:
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


def cache_specs(cache, mesh, tp: bool = True):
    """The reference's rule on every cache leaf: dim 0 over ``dp`` when it
    divides; then the largest remaining dim that ``|model|`` divides
    shards over ``'model'``.

    Give it the reference's layout (``stacked_cache``): there dim 0 of a
    ``stack`` leaf is the period axis, of a prefix leaf the batch.

    Example:
        >>> cache_specs({"stack": {"k": (2, 1, 64, 16)}}, {"data": 2, "model": 2})
        {'stack': {'k': Spec(('data', None, 'model', None))}}
        >>> cache_specs({"prefix": {"k": (8, 4, 64, 16)}}, {"data": 2, "model": 2})
        {'prefix': {'k': Spec(('data', None, 'model', None))}}
    """
    sizes = axis_sizes(mesh)
    dp = dp_axes(sizes, tp)
    msize = sizes["model"] if tp else 1
    return map_specs(lambda _, leaf: _cache_rule(_shape(leaf), sizes, dp, msize), cache)


def drop_fsdp(spec: Spec) -> Spec:
    """A serve spec of weights kept resident: ``'pod'`` and ``'data'``
    dropped, so a weight shards over ``'model'`` only.

    Example:
        >>> drop_fsdp(Spec((("pod", "data"), "model")))
        Spec((None, 'model'))
    """
    dims = []
    for entry in spec:
        axes = _axes(entry)
        if any(a in ("pod", "data") for a in axes):
            kept = tuple(a for a in axes if a not in ("pod", "data"))
            dims.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            dims.append(entry)
    return Spec(dims)


# ------------------------------------------------------ specs on a mesh


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on a mesh (a ``DeviceMesh`` or an
    ``{axis: size}`` mapping, in mesh order): ``Shard(d)`` on every mesh
    dim that tensor dim ``d`` is sharded over, ``Replicate()`` elsewhere.

    Raises:
        ValueError: an axis the mesh lacks, an axis used twice, or a dim's
            axes out of the mesh's order (DTensor nests them in mesh order).
    """
    return list(_placements(Spec(spec), tuple(axis_sizes(mesh))))


@functools.lru_cache(maxsize=None)
def _placements(spec: Spec, names: Tuple[str, ...]) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    names = list(names)
    out = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        for a in axes:
            if a not in names or a in seen:
                raise ValueError(f"spec {spec}: axis {a!r} is not once in the mesh {names}")
            seen.add(a)
            out[names.index(a)] = Shard(d)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
    return tuple(out)


def named(mesh, spec_tree):
    """Bind a tree of specs to ``mesh``: the same tree with each spec's
    DTensor placements."""
    def one(tree):
        if isinstance(tree, Spec):
            return placements(tree, mesh)
        if isinstance(tree, dict):
            return {k: one(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(one(v) for v in tree)
        return tree

    return one(spec_tree)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``."""
    sizes = axis_sizes(mesh)
    return tuple(n // math.prod(sizes[a] for a in _axes(e)) for n, e in zip(shape, spec))


def local_block(full: torch.Tensor, mesh, spec: Spec,
                presharded: Sequence[int] = ()) -> torch.Tensor:
    """This rank's block of ``full`` (the same on every rank) under
    ``spec``: a view (``narrow`` per dim, no copy), so on one rank it is
    ``full`` itself.  Dims in ``presharded`` already hold only this rank's
    part and are not cut.

    Raises:
        ValueError: the spec does not divide the shape (``_fit_spec``
            keeps the rules' specs dividing).
    """
    sizes, coords = axis_sizes(mesh), axis_coords(mesh)
    local = full
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes or d in presharded:
            continue
        size = math.prod(sizes[a] for a in axes)
        if full.shape[d] % size:
            raise ValueError(f"spec {spec} does not divide dim {d} of {tuple(full.shape)}")
        idx = 0
        for a in axes:  # the first axis is the outermost, as in JAX
            idx = idx * sizes[a] + coords[a]
        n = full.shape[d] // size
        local = local.narrow(d, idx * n, n)
    return local


def shard_tensor(full: torch.Tensor, mesh, spec: Spec, presharded: Sequence[int] = (),
                 copy: bool = False):
    """``local_block(full, mesh, spec, presharded)`` as a ``DTensor``.

    Args:
        full: The tensor.
        mesh: The ``DeviceMesh``.
        spec: Its spec.
        presharded: Dims of ``full`` that already hold only this rank's
            part (a rank's own rows): the global shape counts every
            rank's part.
        copy: Copy the block out of ``full`` when it is not all of it, so
            ``full`` can be freed.
    """
    from torch.distributed.tensor import DTensor

    local = local_block(full, mesh, spec, presharded)
    if copy and local.numel() != full.numel():
        local = local.clone()
    sizes = axis_sizes(mesh)
    shape = [n * math.prod(sizes[a] for a in _axes(e)) if d in presharded else n
             for d, (n, e) in enumerate(zip(full.shape, spec))]
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def gather_tensor(local: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """The full tensor from every rank's block: one all-gather per mesh
    axis of each sharded dim (``collectives.gather_dim``, pod-major).

    Args:
        local: This rank's block (a ``DTensor``'s is read through
            ``to_local``).
        mesh: The ``DeviceMesh``.
        spec: The block's spec.

    Returns:
        The gathered tensor; a dim whose axes have one rank in all is not
        gathered, so on a one-rank mesh the result is ``local`` itself (no
        copy).
    """
    if hasattr(local, "to_local"):
        local = local.to_local()
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if axes and math.prod(sizes[a] for a in axes) > 1:
            local = gather_dim(local, mesh, axes, d)
    return local
