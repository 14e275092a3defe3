"""The (m, n, device) schedule autotuner and the attention decisions
(DESIGN.md §5, §8).

``choose_kind`` picks the registered schedule kind a kernel launches for
a simplex dimension, tile count and device, so that ``kind='auto'`` (the
default of every simplex entry point) never hand-picks a schedule; it
resolves through ``core.schedule.resolve_kind``.

1. **Candidates** — the kinds constructible at (m, n): the ``(w, h)``
   trio at m=2, the linear-grid kinds at m >= 3, each through
   ``resolve_kind`` and deduplicated.
2. **Model scores** — ``roofline.analysis.schedule_cost_model`` with
   the H100's measured constants.
3. **Measured ranking** — when ``compiled: true`` ACCUM rows of the
   port's own bench artifact, recorded on the deciding device, cover
   *every* candidate, the decision ranks on them (rescaled to this n by
   the steps ratio); partial coverage keeps the model ranking.  Rows of
   another device, or with none named, are ignored.
4. **Disk cache** — decisions persist in a JSON cache keyed
   ``m,n,device``; an entry is stale when the torch version, the
   artifact's fingerprint or the model's constants change.  A process
   also keeps what it read, keyed the same way.

``choose_attn_impl`` ranks the causal-attention executors (folded and
bounding-box flash, chunked) the same way, behind the reference's
structural guards.

On the CPU the port keeps the reference's interpret-backend rules, so
the CPU tests walk the reference's routes: the attention step cap
``ATTN_INTERPRET_STEP_CAP`` and the interpret tile rule.  On the card
there is no cap, and the tile is the largest one a CUDA kernel is built
for whose block fits ``SMEM_LIMIT``.

Env knobs: ``REPRO_TORCH_AUTOTUNE_CACHE`` (cache file),
``REPRO_TORCH_BENCH_ARTIFACT`` (bench rows), ``REPRO_TORCH_AUTOTUNE_DISABLE=1``
(no cache reads or writes: hermetic runs), ``REPRO_TORCH_SPLIT_PIECES``
(force the per-piece launch split on or off), ``REPRO_TORCH_ATTN_STEP_CAP``
(the CPU attention step cap).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import tempfile
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..kernels.flash_attention import flash_grid_steps, kernel_fits
from ..kernels.policy import resolve_device
from ..roofline import analysis

__all__ = [
    "Decision",
    "AttnDecision",
    "choose_kind",
    "choose_attn_impl",
    "attn_block_q",
    "candidate_kinds",
    "should_split_pieces",
    "clear_cache",
    "cache_path",
    "bench_artifact_path",
    "CACHE_SCHEMA",
    "ATTN_INTERPRET_STEP_CAP",
]

CACHE_SCHEMA = "repro-torch-autotune/v1"

_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_BENCH_ENV = "REPRO_TORCH_BENCH_ARTIFACT"
_DISABLE_ENV = "REPRO_TORCH_AUTOTUNE_DISABLE"
_SPLIT_ENV = "REPRO_TORCH_SPLIT_PIECES"
_ATTN_CAP_ENV = "REPRO_TORCH_ATTN_STEP_CAP"

# The default cache and artifact live in the checkout (the repository
# root is three levels above ``src/repro_torch/autotune``), not in the
# home directory or the working directory.
_ROOT = pathlib.Path(__file__).resolve().parents[3]
_DEFAULT_CACHE = str(_ROOT / "build" / "repro_torch" / "autotune.json")
_DEFAULT_BENCH = str(_ROOT / "BENCH_torch.json")

# CPU attention step budget: heads x grid steps above which the chunked
# executor runs instead of the flash kernel's plain version, the
# reference's interpret-backend cap.  The card has none.
ATTN_INTERPRET_STEP_CAP = 4096

# Decisions this process has made or read, keyed by everything that
# makes a cache entry fresh.
_SEEN: Dict[tuple, object] = {}


@dataclass(frozen=True)
class Decision:
    """One autotuner decision record (also the on-disk cache row).

    Attributes:
        m: Simplex dimension.
        n: Tile count per side the decision applies to.
        device: Device type the decision was made for ('cuda', 'cpu').
        kind: Winning schedule kind (already ``resolve_kind``-concrete).
        source: Provenance — 'measured' (bench row), 'model' (cost
            model) or 'cache' (served from disk).
        score_us: Predicted or measured cost of the winner, microseconds.
        scores_us: Per-candidate scores, for inspection.
        torch_version: torch version the decision was computed under.
        fingerprint: Bench-artifact content hash at decision time.
        constants: Hash of the cost model's constants at decision time.
    """

    m: int
    n: int
    device: str
    kind: str
    source: str
    score_us: float
    scores_us: Dict[str, float]
    torch_version: str
    fingerprint: str
    constants: str


def _torch_version() -> str:
    return torch.__version__


_HASHED: Dict[tuple, str] = {}


def _constants() -> str:
    key = analysis.constants()
    if key not in _HASHED:
        _HASHED.clear()
        _HASHED[key] = hashlib.sha1(repr(key).encode()).hexdigest()[:16]
    return _HASHED[key]


def _device(device) -> str:
    return resolve_device(device).type


def cache_path(path: Optional[str] = None) -> str:
    """Resolve the decision-cache file path (env-overridable).

    Args:
        path: Explicit path; wins over the env var and the default,
            ``build/repro_torch/autotune.json`` in the repository.

    Returns:
        Absolute path of the JSON cache file.
    """
    return os.path.abspath(path or os.environ.get(_CACHE_ENV) or _DEFAULT_CACHE)


def bench_artifact_path(path: Optional[str] = None) -> str:
    """Resolve the port's bench-rows artifact path (env-overridable).

    Args:
        path: Explicit path; wins over the env var and the default,
            ``BENCH_torch.json`` at the repository root.

    Returns:
        Absolute path (the file may be absent: a valid state).
    """
    return os.path.abspath(path or os.environ.get(_BENCH_ENV) or _DEFAULT_BENCH)


def _fingerprint(path: str) -> str:
    if not os.path.isfile(path):
        return "absent"
    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()


def _load_cache(path: str) -> Dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {"schema": CACHE_SCHEMA, "entries": {}}
    if data.get("schema") != CACHE_SCHEMA:
        return {"schema": CACHE_SCHEMA, "entries": {}}
    return data


def _store_cache(path: str, data: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def clear_cache(path: Optional[str] = None) -> None:
    """Delete the on-disk decision cache and what this process kept.

    Args:
        path: Cache file; defaults to ``cache_path()``.
    """
    _SEEN.clear()
    p = cache_path(path)
    if os.path.isfile(p):
        os.unlink(p)


def _cached(key: str, cpath: str, bench_file: str, make, build, refresh: bool):
    """The decision for ``key``: this process's, the disk cache's while
    fresh, else ``build()`` (stored unless the cache is disabled).

    ``make(entry, stamp)`` turns a cache row into a decision; ``stamp``
    is what a fresh row must match.
    """
    disabled = os.environ.get(_DISABLE_ENV, "").strip() == "1"
    stamp = dict(torch_version=_torch_version(), fingerprint=_fingerprint(bench_file),
                 constants=_constants())
    seen = (key, cpath, tuple(stamp.values()))
    if not disabled and not refresh:
        if seen in _SEEN:
            return _SEEN[seen]
        entry = _load_cache(cpath)["entries"].get(key)
        if entry is not None and all(entry.get(k) == v for k, v in stamp.items()):
            _SEEN[seen] = decision = make(entry, stamp)
            return decision
    decision = build(stamp)
    if not disabled:
        cache = _load_cache(cpath)
        row = asdict(decision)
        for k in ("m", "n", "seq", "heads", "head_dim", "dtype", "device"):
            row.pop(k, None)
        cache["entries"][key] = row
        _store_cache(cpath, cache)
        _SEEN[seen] = dataclasses.replace(decision, source="cache")
    return decision


def candidate_kinds(m: int, n: int) -> Tuple[str, ...]:
    """Kinds that actually compete at (m, n), post-``resolve_kind``.

    m=2 restricts to the ``(w, h)``-grid trio the 2-D kernels launch;
    m >= 3 uses the linear-grid kinds.

    Example:
        >>> candidate_kinds(2, 12), candidate_kinds(3, 6)
        (('rb', 'bb'), ('composite', 'table', 'bb'))
    """
    from ..core.schedule import registered_kinds, resolve_kind

    base = ("hmap", "rb", "bb") if m == 2 else ("hmap", "table", "composite", "bb")
    avail = set(registered_kinds(m))
    out: List[str] = []
    for k in base:
        if k not in avail:
            continue
        r = resolve_kind(m, n, k)
        if r not in out:
            out.append(r)
    return tuple(out)


def _model_scores(m: int, n: int, kinds: Tuple[str, ...]) -> Dict[str, float]:
    """Cost-model score (us) per candidate kind.

    The memory term is evaluated at ``analysis.WARP_TILE_ELEMS`` spread
    over m axes, the least a step of the CUDA kernels moves.
    """
    from ..core.schedule import SimplexSchedule
    from ..core.trapezoids import decompose_simplex

    rho_model = max(2, round(analysis.WARP_TILE_ELEMS ** (1.0 / m)))
    scores = {}
    for kind in kinds:
        sched = SimplexSchedule(m, n, kind)
        pieces = len(decompose_simplex(m, n)) if kind == "composite" else 1
        s = analysis.schedule_cost_model(
            kind, sched.steps, m=m, n=n, useful=sched.useful, pieces=pieces,
            rho=rho_model,
        )
        scores[kind] = s * 1e6
    return scores


def _rows(bench_file: str, device: str):
    """The artifact's ``compiled: true`` rows recorded on ``device``."""
    try:
        with open(bench_file) as f:
            artifact = json.load(f)
    except (OSError, json.JSONDecodeError):
        return []
    return [r for r in artifact.get("rows", [])
            if r.get("compiled") and r.get("device") == device
            and r.get("us_per_call") and r.get("grid_steps")]


def _rescaled(rows, here_steps) -> Dict[str, float]:
    """Per kind, the row nearest in steps, its time scaled to ``here_steps(kind)``."""
    best: Dict[str, Tuple[float, float]] = {}
    for row in rows:
        kind = row["map"]
        here = here_steps(kind)
        scaled = float(row["us_per_call"]) * here / float(row["grid_steps"])
        dist = abs(float(row["grid_steps"]) - here)
        if kind not in best or dist < best[kind][0]:
            best[kind] = (dist, scaled)
    return {k: v[1] for k, v in best.items()}


def _measured_scores(m: int, n: int, kinds: Tuple[str, ...], device: str,
                     bench_file: str) -> Dict[str, float]:
    """Scores (us) from recorded ACCUM rows of ``device``, rescaled by the
    steps ratio."""
    from ..core.schedule import SimplexSchedule

    rows = [r for r in _rows(bench_file, device)
            if str(r.get("test") or "").startswith("ACCUM") and r.get("m") == m
            and r.get("map") in kinds]
    return _rescaled(rows, lambda kind: SimplexSchedule(m, n, kind).steps)


def choose_kind(m: int, n: int, device=None, *, bench_path: Optional[str] = None,
                cache_file: Optional[str] = None, refresh: bool = False) -> Decision:
    """Pick the schedule kind for (m, n, device); cache on disk.

    Args:
        m: Simplex dimension (m >= 2).
        n: Tile count per side.
        device: Where the kernel runs; None means the card.
        bench_path: Bench artifact override (else env/default).
        cache_file: Cache file override (else env/default).
        refresh: Recompute even on a fresh cache hit.

    Returns:
        The winning ``Decision`` (``.kind`` is what kernels launch).

    Example:
        >>> import os
        >>> os.environ["REPRO_TORCH_AUTOTUNE_DISABLE"] = "1"  # hermetic
        >>> d = choose_kind(3, 8, device="cpu")
        >>> d.kind in candidate_kinds(3, 8) and d.source
        'model'
        >>> del os.environ["REPRO_TORCH_AUTOTUNE_DISABLE"]
    """
    dev = _device(device)
    bench_file = bench_artifact_path(bench_path)

    def make(entry, stamp):
        return Decision(m=m, n=n, device=dev, kind=entry["kind"], source="cache",
                        score_us=entry["score_us"], scores_us=entry.get("scores_us", {}),
                        **stamp)

    def build(stamp):
        kinds = candidate_kinds(m, n)
        measured = _measured_scores(m, n, kinds, dev, bench_file)
        # Rank on measured times only when every candidate has one: a
        # measured wall-clock and a model estimate are different units.
        use_measured = set(kinds) <= set(measured)
        merged = dict(measured) if use_measured else _model_scores(m, n, kinds)
        winner = min(merged, key=merged.get)
        return Decision(m=m, n=n, device=dev, kind=winner,
                        source="measured" if use_measured else "model",
                        score_us=merged[winner], scores_us=merged, **stamp)

    return _cached(f"m={m},n={n},device={dev}", cache_path(cache_file), bench_file, make,
                   build, refresh)


# ---------------------------------------------------------------------------
# Attention-executor decisions (the serving hot path — DESIGN.md §8)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttnDecision:
    """One causal-attention dispatch decision (and its cache row).

    Attributes:
        seq: Sequence length.
        heads: Query-head count.
        head_dim: Head dimension.
        dtype: The activations' dtype name.
        device: Device type the decision is for (``'cuda'`` or ``'cpu'``).
        impl: ``'flash'`` or ``'chunked'``.
        kind: ``'folded'`` / ``'bb'`` for flash, ``'chunked'`` otherwise.
        block_q: Square tile side for the flash kernel; 0 when none maps
            the shape.
        source: 'measured', 'model', 'cache' or 'fallback' (the flash
            kernel cannot map the shape, or the CPU step cap).
        score_us: Predicted or measured cost of the winner, microseconds.
        scores_us: Per-candidate scores, for inspection.
        torch_version: torch version at decision time.
        fingerprint: Bench-artifact content hash at decision time.
        constants: Hash of the cost model's constants at decision time.
    """

    seq: int
    heads: int
    head_dim: int
    dtype: str
    device: str
    impl: str
    kind: str
    block_q: int
    source: str
    score_us: float
    scores_us: Dict[str, float]
    torch_version: str
    fingerprint: str
    constants: str


_ATTN_BLOCKS = (128, 64, 32, 16, 8)


def attn_block_q(seq: int, head_dim: int, device=None, dtype=torch.float32) -> int:
    """Square attention tile side for a sequence length (0 if none fits).

    On the CPU: the largest of (128, 64, 32, 16, 8) dividing ``seq`` that
    still gives at least two query tiles (else the largest divisor), the
    JAX package's interpret rule.  On the card: the largest divisor a
    CUDA kernel is built for whose block, for ``dtype``, fits
    ``policy.SMEM_LIMIT``.

    Args:
        seq: Sequence length.
        head_dim: Attention head dimension.
        device: Device the kernel runs on; None means the card.
        dtype: The activations' dtype (the kernel and its shared memory
            depend on it on the card).

    Example:
        >>> attn_block_q(64, 16, device="cpu")   # two tiles: the fold runs
        32
        >>> attn_block_q(60, 16, device="cpu")
        0
    """
    dev = resolve_device(device)
    divisors = [bq for bq in _ATTN_BLOCKS if bq <= seq and seq % bq == 0]
    if dev.type == "cuda":
        divisors = [bq for bq in divisors if kernel_fits(bq, head_dim, dtype)]
        return divisors[0] if divisors else 0
    for bq in divisors:
        if seq // bq >= 2:
            return bq
    return divisors[0] if divisors else 0


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _attn_steps(nq: int, heads: int, kind: str) -> int:
    return heads * flash_grid_steps(nq, "bb" if kind == "bb" else "folded")


def _attn_model_scores(nq: int, heads: int, head_dim: int, block_q: int,
                       dtype) -> Dict[str, float]:
    """Cost-model prior (us) per attention executor: the fold halves the
    block-pair visits of the bounding box, whose idle pairs cost their
    predicate; the chunked executor round-trips its score tiles."""
    tri = nq * (nq + 1) // 2
    name = _dtype_name(dtype)
    size = torch.empty((), dtype=dtype).element_size()
    return {
        kind: analysis.schedule_cost_model(
            f"attn-{kind}", _attn_steps(nq, heads, kind), m=2, n=nq, useful=heads * tri,
            rho=block_q, dtype_bytes=size, head_dim=head_dim, dtype=name,
        ) * 1e6
        for kind in ("folded", "bb", "chunked")
    }


def _measured_attn_scores(nq: int, heads: int, kinds: Tuple[str, ...], device: str,
                          dtype, bench_file: str) -> Dict[str, float]:
    """Scores (us) from recorded ATTN rows of ``device`` (and of ``dtype``
    where a row names one), rescaled by the steps ratio."""
    name = _dtype_name(dtype)
    rows = [r for r in _rows(bench_file, device)
            if r.get("test") == "ATTN" and r.get("map") in kinds
            and r.get("dtype", name) == name]
    return _rescaled(rows, lambda kind: _attn_steps(nq, heads, kind))


def choose_attn_impl(seq: int, heads: int, head_dim: int, device=None,
                     dtype=torch.float32, *, bench_path: Optional[str] = None,
                     cache_file: Optional[str] = None,
                     refresh: bool = False) -> AttnDecision:
    """Pick the causal-attention executor for ``(seq, heads, head_dim)``.

    The dispatch decision of ``models.attention.simplex_attention`` and
    ``ops.causal_flash_attention`` (``kind='auto'``), cached on disk next
    to the schedule decisions.  Ranking: measured ``compiled: true`` ATTN
    rows of this device when they cover every candidate, else the cost
    model's ``attn-*`` entries.  Two structural guards override it:

    * no tile maps ``seq`` (``attn_block_q`` is 0): the chunked executor
      runs, ``source='fallback'``;
    * on the CPU, ``heads x grid_steps`` beyond ``ATTN_INTERPRET_STEP_CAP``
      (env ``REPRO_TORCH_ATTN_STEP_CAP``): the chunked executor runs, as
      the reference's interpret backends do; the card has no cap.

    Args:
        seq: Sequence length.
        heads: Query-head count per example.
        head_dim: Attention head dimension.
        device: Device the attention runs on; None means the card.
        dtype: The activations' dtype.
        bench_path: Bench artifact override (else env/default).
        cache_file: Cache file override (else env/default).
        refresh: Recompute even on a fresh cache hit.

    Returns:
        The winning ``AttnDecision``.

    Example:
        >>> import os
        >>> os.environ["REPRO_TORCH_AUTOTUNE_DISABLE"] = "1"  # hermetic
        >>> d = choose_attn_impl(64, 4, 16, device="cpu")
        >>> (d.impl, d.kind, d.block_q)
        ('flash', 'folded', 32)
        >>> del os.environ["REPRO_TORCH_AUTOTUNE_DISABLE"]
    """
    dev = _device(device)
    name = _dtype_name(dtype)
    bench_file = bench_artifact_path(bench_path)
    base = dict(seq=seq, heads=heads, head_dim=head_dim, dtype=name, device=dev)

    def make(entry, stamp):
        return AttnDecision(**base, impl=entry["impl"], kind=entry["kind"],
                            block_q=entry["block_q"], source="cache",
                            score_us=entry["score_us"],
                            scores_us=entry.get("scores_us", {}), **stamp)

    def build(stamp):
        block = attn_block_q(seq, head_dim, dev, dtype)
        nq = seq // block if block else 0
        flash_ok = block > 0
        if flash_ok and dev == "cpu":
            cap = int(os.environ.get(_ATTN_CAP_ENV, "") or ATTN_INTERPRET_STEP_CAP)
            flash_ok = _attn_steps(nq, heads, "folded") <= cap
        if not flash_ok:
            return AttnDecision(**base, impl="chunked", kind="chunked", block_q=block,
                                source="fallback", score_us=0.0, scores_us={}, **stamp)
        kinds = ("folded", "bb", "chunked")
        measured = _measured_attn_scores(nq, heads, kinds, dev, dtype, bench_file)
        use_measured = set(kinds) <= set(measured)
        merged = (dict(measured) if use_measured
                  else _attn_model_scores(nq, heads, head_dim, block, dtype))
        winner = min(merged, key=merged.get)
        return AttnDecision(**base, impl="chunked" if winner == "chunked" else "flash",
                            kind=winner, block_q=block,
                            source="measured" if use_measured else "model",
                            score_us=merged[winner], scores_us=merged, **stamp)

    key = f"attn,s={seq},h={heads},d={head_dim},dtype={name},device={dev}"
    return _cached(key, cache_path(cache_file), bench_file, make, build, refresh)


def should_split_pieces(n_pieces: int, steps: int) -> bool:
    """Split a composite schedule into per-piece launches?

    The composite map pays its piece chain on every step; splitting
    removes the chain at the cost of one more launch per piece.  Per
    extra launch the saving is ``steps * SELECT_S``, so split when that
    exceeds ``LAUNCH_OVERHEAD_S`` (both the card's) and there are enough
    pieces for the chain to matter.  ``REPRO_TORCH_SPLIT_PIECES=1/0``
    forces it.

    Args:
        n_pieces: Piece count of the decomposition.
        steps: Total grid steps of the unsplit schedule.

    Returns:
        True when per-piece launches are predicted to win.

    Example:
        >>> should_split_pieces(2, 10**9), should_split_pieces(30, 10**4)
        (False, False)
    """
    env = os.environ.get(_SPLIT_ENV, "").strip()
    if env == "1":
        return True
    if env == "0":
        return False
    if n_pieces < 4:
        return False
    return steps * analysis.SELECT_S > analysis.LAUNCH_OVERHEAD_S
