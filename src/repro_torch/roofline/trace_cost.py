"""What a traced step cost: kernel time, idle gaps, FLOPs, collectives.

The port's counterpart of the JAX package's ``repro/roofline/hlo_cost.py``.
The reference reads the cost of a step from its compiled HLO; the port
reads what the step did:

* ``kernel_table`` and ``device_timeline`` read a ``torch.profiler``
  trace taken with ``activities=[CPU, CUDA]``: device time and launches by
  kernel name, the device's busy and idle share over the traced window,
  and its longest idle gaps with the host op that ran under each.  A trace
  with no device events (the CPU) has no device figures: they are
  ``None``, never a host time under a device name.
* ``flop_count`` counts FLOPs per op with
  ``torch.utils.flop_counter.FlopCounterMode``, and the bytes the ops
  read and write (each op's tensor inputs and outputs, views and
  allocations excluded: an upper bound at op granularity, as the
  reference's HLO bytes are at its fusions').  The hand-written kernels
  run as dispatcher ops of their own (``torch.ops.repro_torch.*``, with
  their shapes registered for ``meta``), so the counters see each as one
  op; their formulas are registered here: the flash forward's
  (``repro_torch.flash_attention``) causal products,
  ``4 B Hq D S(S+1)/2``, and EDM's (``repro_torch.edm``) Gram products,
  one ``rho x rho x d`` product per point pair of every simplex tile.
* ``summarize`` puts them together with
  ``roofline.analysis.collective_census`` over the trace's ``gloo:`` and
  ``nccl:`` records.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import engine, flash_attention  # noqa: F401  (define the kernels' ops)
from .analysis import collective_census

__all__ = ["flop_count", "kernel_table", "device_timeline", "host_ops", "summarize"]


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(kind, block_q, scale, q, k, v, bias, seg, out_shape=None, **_) -> int:
    """The causal forward's useful products: ``QK^T`` and ``PV`` over the
    lower triangle, diagonal included (``2 D`` FLOPs each a pair)."""
    b, hq, s, d = q
    return 4 * b * hq * d * s * (s + 1) // 2


@register_flop_formula(torch.ops.repro_torch.edm)
def _edm_flops(p, m, rho, kind, split, out_shape=None, **_) -> int:
    """EDM's Gram products: every tile of ``T^m(n / rho)`` takes one
    ``rho x rho x d`` product for each of its ``m(m-1)/2`` point pairs."""
    n, d = p
    return math.comb(n // rho + m - 1, m) * math.comb(m, 2) * 2 * rho * rho * d


class _ByteCounter(TorchDispatchMode):
    """Bytes of every op's tensor inputs and outputs, views and
    allocations excluded."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and not func.__name__.startswith(("empty", "new_empty")):
            self.total += _nbytes((args, kwargs, out))
        return out


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def flop_count(fn: Callable, *args, **kwargs) -> Tuple[object, Dict[str, int], int]:
    """``fn(*args, **kwargs)`` under a FLOP and byte count.

    Returns:
        ``(result, {op: FLOPs}, bytes)``: ops by their overload packet's
        name (``aten.mm``, ``repro_torch.flash_attention``); the bytes the ops read and wrote.

    Example:
        >>> _, flops, moved = flop_count(torch.mm, torch.ones(4, 8), torch.ones(8, 2))
        >>> flops, moved
        ({'aten.mm': 128}, 224)
    """
    counter, moved = FlopCounterMode(display=False), _ByteCounter()
    with counter, moved:
        out = fn(*args, **kwargs)
    return out, {str(op): int(v) for op, v in counter.get_flop_counts()["Global"].items()
                 if v}, moved.total


def _device_events(events) -> List:
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def kernel_table(events) -> Dict[str, Dict[str, float]]:
    """Device time (``us``) and launches of each kernel name of a trace,
    longest first; empty when the trace has no device events."""
    table: Dict[str, Dict[str, float]] = {}
    for e in _device_events(events):
        row = table.setdefault(e.name, {"us": 0.0, "launches": 0})
        row["us"] += e.time_range.elapsed_us()
        row["launches"] += 1
    return dict(sorted(table.items(), key=lambda kv: -kv[1]["us"]))


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _host_op(cpu, a: float, b: float) -> Optional[str]:
    """The host op under the gap ``[a, b)``: the shortest one that covers
    half of it, else the one that covers most of it."""
    over = [(min(b, e.time_range.end) - max(a, e.time_range.start), e) for e in cpu]
    over = [(c, e) for c, e in over if c > 0]
    if not over:
        return None
    half = [e for c, e in over if c >= (b - a) / 2]
    if half:
        return min(half, key=lambda e: e.time_range.elapsed_us()).name
    return max(over, key=lambda ce: ce[0])[1].name


def device_timeline(events, gaps: int = 5) -> Optional[Dict]:
    """The device's busy and idle share over the traced window (from the
    first event of either side to the last) and its ``gaps`` longest idle
    gaps, each with the host op under it; ``None`` when the trace has no
    device events."""
    dev = _device_events(events)
    if not dev:
        return None
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    everything = spans + [(e.time_range.start, e.time_range.end) for e in cpu]
    t0, t1 = min(a for a, _ in everything), max(b for _, b in everything)
    busy = _union(spans)
    busy_us = sum(b - a for a, b in busy)
    idle = [(a, b) for a, b in zip([t0] + [b for _, b in busy], [a for a, _ in busy] + [t1])
            if b > a]
    idle.sort(key=lambda ab: ab[0] - ab[1])
    return {
        "window_us": t1 - t0,
        "busy_us": busy_us,
        "busy_share": busy_us / (t1 - t0) if t1 > t0 else 0.0,
        "idle_share": 1.0 - busy_us / (t1 - t0) if t1 > t0 else 0.0,
        "gaps": [{"us": b - a, "at_us": a - t0, "host_op": _host_op(cpu, a, b)}
                 for a, b in idle[:gaps]],
    }


def host_ops(events) -> Dict[str, Dict[str, float]]:
    """Calls and host time (``host_us``, wall time of the op on the host,
    children included) of each host op name, the longest first."""
    table: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        row = table.setdefault(e.name, {"calls": 0, "host_us": 0.0})
        row["calls"] += 1
        row["host_us"] += e.time_range.elapsed_us()
    return dict(sorted(table.items(), key=lambda kv: -kv[1]["host_us"]))


def summarize(events, flops: Optional[Dict[str, int]] = None, group_size: int = 1,
              gaps: int = 5) -> Dict:
    """One traced step: ``kernels`` (``kernel_table``), ``device``
    (``device_timeline``, ``None`` without device events), ``host_ops``,
    ``flops`` and ``flops_total`` (``flop_count``'s, when given) and
    ``collectives`` (``collective_census`` with ``group_size``)."""
    return {
        "kernels": kernel_table(events),
        "device": device_timeline(events, gaps),
        "host_ops": host_ops(events),
        "flops": dict(flops or {}),
        "flops_total": sum((flops or {}).values()),
        "collectives": collective_census(events, group_size),
    }
