"""The schedule cost model the port's autotuner ranks with, on the H100.

``schedule_cost_model`` predicts the seconds one launch of a schedule
kind takes: the tile traffic of the steps that do work, plus the
per-step cost of the kind's map.  ``autotune.tuner`` ranks candidate
kinds, causal-attention executors and the composite launch split with it
when no measured row applies.

Every constant is this card's: the values below are those of the
``tuner constant`` lines of one ``chip_smoke.py`` run, whose ``tuner``
phase measures each one the way its comment says and prints it beside
the value here, on an NVIDIA H100 80GB HBM3 at 700.00 W (``nvidia-smi
--query-gpu=name,power.limit``).  The per-step costs are throughputs of the whole card: the time one step adds to a
launch that has hundreds of thousands of them in flight.

The reference's second half reads compiled HLO; the port's reads what a
step did (``roofline/trace_cost.py``): ``wire_bytes`` is the reference's
ring model of a collective's per-rank traffic, ``collective_census``
counts the collectives of a ``torch.profiler`` trace, ``roofline_terms``
gives a dry-run record's compute, memory-floor and collective seconds on
the card's peaks (``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW``), and
``load_cells`` reads the dry run's records back.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Mapping, Optional

__all__ = [
    "PEAK_FLOPS",
    "LINK_BW",
    "wire_bytes",
    "collective_census",
    "roofline_terms",
    "load_cells",
    "HBM_BW",
    "SELECT_S",
    "SMEM_READ_S",
    "PREDICATE_S",
    "LAUNCH_OVERHEAD_S",
    "HOST_ENUM_S",
    "TABLE_AMORTIZE",
    "ATTN_PEAK_FLOPS",
    "IDLE_STEP_TRAFFIC",
    "LEVELS_2D",
    "COMPOSITE_DECODE_LEVELS",
    "WARP_TILE_ELEMS",
    "constants",
    "schedule_cost_model",
]

# Bytes/s: one ``copy_`` of a 1 GiB float32 tensor, twice its bytes over
# the median CUDA-event time (NVIDIA H100 80GB HBM3, 700.00 W).
HBM_BW = 2.958e12
# ACCUM's kernel (``kernel_``) on a one-element tile (rho 1) of an int32
# 256^3 cube, m=3, median CUDA-event time over the schedule's steps: a
# step's map and its one-element work (NVIDIA H100 80GB HBM3, 700.00 W).
# Per recursion level: the ``hmap`` walk's time per step over its 8 levels.
SELECT_S = 2.908e-11
# Per step of the ``table`` walk (the map reads its m int32s from the
# table's device array).
SMEM_READ_S = 3.055e-10
# Per step of the ``bb`` walk, five in six of them off the simplex: a
# wasted step costs a warp that reads its map, tests it and returns.
PREDICATE_S = 1.216e-10
# One more launch through the Python wrapper, host work included:
# ``engine.accum_`` at m=4, n=60, rho=4, kind='composite', its 30
# per-piece launches against the fused one, the difference over 29
# (NVIDIA H100 80GB HBM3, 700.00 W; the card's host).
LAUNCH_OVERHEAD_S = 2.086e-5
# Host seconds per cell of a table build: ``SimplexSchedule(3, 256,
# 'table').prefetch`` built fresh, over its cells (the card's host).
HOST_ENUM_S = 2.575e-8
# Launches a built table is amortized over: a policy, not a measurement
# (the engine builds each schedule once per process).
TABLE_AMORTIZE = 1000
# FLOP/s of ``torch.matmul`` on two 8192 x 8192 matrices of each dtype,
# float32 without TF32 (the chunked executor's products), median
# CUDA-event time (NVIDIA H100 80GB HBM3, 700.00 W).
ATTN_PEAK_FLOPS = {"float32": 5.135e13, "bfloat16": 7.700e14, "float16": 7.640e14}
# Share of a tile's traffic a step off the simplex moves.  The CUDA
# kernels return from an invalid step before they touch memory, so 0:
# ACCUM int32 m=2 n=16384 rho 16 takes about 5 % longer over the bounding
# box (1,048,576 steps, half of them off the simplex) than over hmap's
# 524,800 (``tuner case`` line), where a tile's traffic for each idle step
# would double it.  The reference charges a full tile (1), since a TPU
# grid step always copies its blocks.
IDLE_STEP_TRAFFIC = 0.0
# Select-chain elements of one step of the m=2 ``hmap`` and ``rb`` maps.
# The device map evaluates both in closed form (hmap2 finds its level
# with one ``__clz``, the paper's Eq. 17/18; rb is a compare and a
# select), so 1.  The reference charges its branchless chain over the
# log2(n) levels (None).
LEVELS_2D = 1
# Recursion levels a composite step decodes besides its piece search.
# The device map finds the piece, then decodes its factor chain, whose
# power-of-two factors are the recursion: ACCUM on one-element tiles at
# m=3, n=256 took 0.37 ns a step over the one-piece composite walk
# against 0.23 over the recursion itself (``tuner step`` lines).
# The reference charges the piece chain alone (0).
COMPOSITE_DECODE_LEVELS = 1
# Elements of the tile the model moves per step: one warp-wide pass of
# 16-byte pieces of 4-byte elements, the least a step of ``accum.cu`` or
# ``ca.cu`` moves (32 lanes x 4 elements).
WARP_TILE_ELEMS = 32 * 16 // 4


def constants() -> tuple:
    """The model's constants, in a fixed order (the tuner's cache key
    holds a hash of them, so a decision outlives no change of them).

    Example:
        >>> len(constants())
        12
    """
    return (HBM_BW, SELECT_S, SMEM_READ_S, PREDICATE_S, LAUNCH_OVERHEAD_S, HOST_ENUM_S,
            TABLE_AMORTIZE, tuple(sorted(ATTN_PEAK_FLOPS.items())), IDLE_STEP_TRAFFIC, LEVELS_2D,
            COMPOSITE_DECODE_LEVELS, WARP_TILE_ELEMS)


def schedule_cost_model(
    kind: str,
    steps: int,
    *,
    m: int,
    n: int,
    useful: int,
    pieces: int = 1,
    rho: int = 8,
    dtype_bytes: int = 4,
    hbm_bw: float = None,
    head_dim: int = 0,
    dtype: str = "float32",
) -> float:
    """Predicted seconds per launch of one schedule kind.

    The reference's two terms, weighed by what the card measured:

    * tile traffic — each step that does work streams one ``(rho,)*m``
      tile in and out: ``busy * 2 * rho^m * dtype_bytes / hbm_bw`` with
      ``busy = useful + IDLE_STEP_TRAFFIC * (steps - useful)``.  On
      Hopper a step off the simplex moves nothing (``IDLE_STEP_TRAFFIC``
      is 0) and costs only its map and predicate, below; the reference
      charges it a full tile, which a TPU grid step does move.
    * map overhead — per step: ``bb`` one predicate; ``table`` one read
      of the table (plus its host build amortized over
      ``TABLE_AMORTIZE`` launches); ``hmap``/``octant``/``rb`` a
      ``log2(n)``-level select chain, ``LEVELS_2D`` selects for the
      closed-form maps at m=2; ``composite`` the O(pieces) chain
      plus ``COMPOSITE_DECODE_LEVELS`` times the recursion's levels, since
      the device map decodes the piece's factor chain too.

    Attention entries ``attn-folded`` / ``attn-bb`` / ``attn-chunked``
    model the causal-attention executors on the 2-simplex tile grid
    (``steps`` = block-pair visits, ``rho`` = the square score tile,
    ``head_dim`` = D): each busy step moves three ``rho x head_dim``
    operand tiles and the output tile and does two ``rho x rho x
    head_dim`` products at ``ATTN_PEAK_FLOPS[dtype]``; the chunked
    executor also round-trips its score tile through memory.  Per step:
    the fold's select pair, the bounding box's predicate, or the chunked
    executor's tile gather.

    Args:
        kind: Registered schedule kind, or an ``attn-*`` entry.
        steps: Grid steps the schedule launches.
        m: Simplex dimension.
        n: Tile count per side.
        useful: Simplex cells covered (the steps that do work).
        pieces: Composite piece count (ignored for other kinds).
        rho: Tile side in elements.
        dtype_bytes: Element width.
        hbm_bw: Memory bandwidth; None is ``HBM_BW``.
        head_dim: Attention head dim (``attn-*`` kinds only).
        dtype: Activation dtype name of the ``attn-*`` products.

    Returns:
        Predicted seconds for one launch of the whole walk.

    Example:
        >>> a = schedule_cost_model("bb", 4096, m=2, n=64, useful=2080)
        >>> b = schedule_cost_model("hmap", 2080, m=2, n=64, useful=2080)
        >>> a > 0 and b > 0
        True
    """
    bw = HBM_BW if hbm_bw is None else hbm_bw
    busy = useful + IDLE_STEP_TRAFFIC * max(steps - useful, 0)
    if kind.startswith("attn-"):
        d = head_dim or rho
        tile_bytes = (3 * rho * d + rho * d) * dtype_bytes  # q, k, v in + o out
        if kind == "attn-chunked":
            tile_bytes += 2 * rho * rho * dtype_bytes  # the score tile's round trip
        t_mem = busy * tile_bytes / bw
        t_mxu = busy * 2 * (2 * rho * rho * d) / ATTN_PEAK_FLOPS[dtype]
        per_step = {
            "attn-folded": 2 * SELECT_S,
            "attn-bb": PREDICATE_S,
            "attn-chunked": SMEM_READ_S,
        }.get(kind)
        if per_step is None:
            raise ValueError(f"unknown attention cost-model kind {kind!r}")
        return t_mem + t_mxu + steps * per_step
    t_mem = busy * 2 * (rho**m) * dtype_bytes / bw
    build = 0.0
    levels = max(int(n - 1).bit_length(), 1)
    if kind == "bb":
        per_step = PREDICATE_S
    elif kind == "table":
        per_step = SMEM_READ_S
        build = useful * HOST_ENUM_S / TABLE_AMORTIZE
    elif kind == "composite":
        per_step = SELECT_S * (max(pieces, 1) + COMPOSITE_DECODE_LEVELS * levels)
    else:  # hmap / octant / rb: select chain over the recursion levels
        per_step = SELECT_S * (LEVELS_2D if m == 2 and LEVELS_2D else levels)
    return t_mem + steps * per_step + build


# ------------------------------------------------- traces and dry runs

# FLOP/s of one H100 SXM at 700 W by operand type (NVIDIA's data sheet,
# dense): float32 outside the tensor cores, TF32 and 16-bit on them.  The
# measured ``ATTN_PEAK_FLOPS`` above are what ``torch.matmul`` reaches.
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12, "float16": 989e12}
# Bytes/s one H100 SXM sends over NVLink 4: 900 GB/s in both directions
# together over its 18 links (NVIDIA's data sheet), so 450e9 each way.
LINK_BW = 450e9

# A trace's collective records: ``gloo:<op>`` and ``nccl:<op>`` host ops.
_COLL_RE = re.compile(r"^(?:gloo|nccl):(\w+)$")
_COLL_KIND = {"all_gather": "all-gather", "allgather": "all-gather",
              "all_gather_into_tensor": "all-gather", "_allgather_base": "all-gather",
              "reduce_scatter": "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
              "_reduce_scatter_base": "reduce-scatter", "all_reduce": "all-reduce",
              "allreduce": "all-reduce", "all_to_all": "all-to-all", "alltoall": "all-to-all",
              "all_to_all_single": "all-to-all", "alltoall_base": "all-to-all",
              "broadcast": "broadcast", "send": "collective-permute",
              "recv": "collective-permute"}
_TYPE_BYTES = {"float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2, "int": 4,
               "long int": 8, "short int": 2, "signed char": 1, "unsigned char": 1,
               "bool": 1}


def wire_bytes(kind: str, operand: int, result: int, g: int) -> float:
    """Bytes one rank sends for one collective of a group of ``g``, on a
    ring: the reference's model (``broadcast`` from a ring's root moves
    the operand once a rank).

    Example:
        >>> wire_bytes("all-reduce", 1024, 1024, 4)
        1536.0
    """
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result * (g - 1) / g
    if kind == "reduce-scatter":
        return operand * (g - 1) / g
    if kind == "all-reduce":
        return operand * 2 * (g - 1) / g
    if kind == "all-to-all":
        return operand * (g - 1) / g
    if kind in ("collective-permute", "broadcast"):
        return float(operand)
    return 0.0


def collective_census(events, group_size: int = 2) -> Dict:
    """Per-kind counts, operand bytes and wire bytes of the collectives of
    a ``torch.profiler`` trace taken with ``record_shapes=True``.

    Args:
        events: ``prof.events()`` (each with ``name``, ``input_shapes``
            and ``input_dtypes``).
        group_size: The ranks of the collectives' groups; a trace does not
            record it, so the caller, who built the mesh, says.

    Returns:
        ``{"per_kind": {kind: {"count", "operand_bytes", "wire_bytes"}},
        "wire_bytes_per_chip": total}``, the reference's layout.  An
        all-gather's result is its operand times ``group_size``.
    """
    per_kind: Dict[str, Dict[str, float]] = {}
    total = 0.0
    for e in events:
        m = _COLL_RE.match(e.name)
        if not m or m.group(1) not in _COLL_KIND:
            continue
        kind = _COLL_KIND[m.group(1)]
        dtypes = list(getattr(e, "input_dtypes", None) or [])
        operand = 0
        for i, shape in enumerate(e.input_shapes or []):
            n = 1
            for d in shape:
                n *= d
            operand += n * _TYPE_BYTES.get(dtypes[i] if i < len(dtypes) else "float", 4)
        result = operand * group_size if kind == "all-gather" else operand
        wb = wire_bytes(kind, operand, result, group_size)
        k = per_kind.setdefault(kind, {"count": 0, "operand_bytes": 0.0, "wire_bytes": 0.0})
        k["count"] += 1
        k["operand_bytes"] += operand
        k["wire_bytes"] += wb
        total += wb
    return {"per_kind": per_kind, "wire_bytes_per_chip": total}


def roofline_terms(rec: Mapping, peak_flops: Optional[float] = None,
                   hbm_bw: Optional[float] = None, link_bw: Optional[float] = None) -> Dict:
    """The reference's three terms of one dry-run record
    (``launch/dryrun.py``), per chip, on the card's peaks.

    ``compute_s`` is the step's FLOPs over the chips' peak (``rec
    ["dtype"]``'s entry of ``PEAK_FLOPS``, float32 by default);
    ``memory_floor_s`` each chip streaming its model-parallel slice of the
    float32 weights once a pass (three passes a microbatch to train);
    ``memory_s`` the record's bytes over ``HBM_BW`` (an upper bound);
    ``collective_s`` its wire bytes over ``LINK_BW``.  ``useful_ratio`` is
    ``6 N tokens`` (train; ``2 N`` otherwise) over the counted FLOPs, and
    ``roofline_fraction`` that ideal time over the largest term.

    Example:
        >>> rec = {"n_chips": 4, "flops": 8e12, "bytes_accessed": 1e9, "mode": "decode",
        ...        "params": 1e6, "params_active": 1e6, "tokens": 4,
        ...        "collectives": {"wire_bytes_per_chip": 0.0}}
        >>> roofline_terms(rec)["dominant"]
        'compute'
    """
    peak = peak_flops or PEAK_FLOPS[rec.get("dtype", "float32")]
    bw = hbm_bw or HBM_BW
    link = link_bw or LINK_BW
    chips = rec["n_chips"]
    passes = (3 * rec.get("microbatches", 1)) if rec["mode"] == "train" else 1
    terms = {
        "compute_s": rec["flops"] / (chips * peak),
        "memory_floor_s": passes * (rec["params"] * 4.0) / rec.get("model_axis", 16) / bw,
        "collective_s": rec["collectives"]["wire_bytes_per_chip"] / link,
    }
    dom = max(terms, key=terms.get)
    model_flops = (6 if rec["mode"] == "train" else 2) * rec["params_active"] * rec["tokens"]
    bound = max(terms.values())
    return {
        **terms,
        "memory_s": rec["bytes_accessed"] / (chips * bw),
        "dominant": dom.replace("_s", "").replace("_floor", ""),
        "model_flops": model_flops,
        "useful_ratio": model_flops / max(rec["flops"], 1.0),
        "roofline_fraction": (model_flops / (chips * peak)) / bound if bound > 0 else 0.0,
    }


def load_cells(outdir: str, mesh: str) -> List[Dict]:
    """The dry run's records of one mesh (``<outdir>/<mesh>/*.json``), in
    file-name order; none when the directory is absent."""
    d = os.path.join(outdir, mesh)
    if not os.path.isdir(d):
        return []
    cells = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                cells.append(json.load(fh))
    return cells
