"""The port's (m, n, device) schedule autotuner and attention decisions."""

from .tuner import (
    ATTN_INTERPRET_STEP_CAP,
    CACHE_SCHEMA,
    AttnDecision,
    Decision,
    attn_block_q,
    bench_artifact_path,
    cache_path,
    candidate_kinds,
    choose_attn_impl,
    choose_kind,
    clear_cache,
    should_split_pieces,
)

__all__ = [
    "ATTN_INTERPRET_STEP_CAP",
    "CACHE_SCHEMA",
    "AttnDecision",
    "Decision",
    "attn_block_q",
    "bench_artifact_path",
    "cache_path",
    "candidate_kinds",
    "choose_attn_impl",
    "choose_kind",
    "clear_cache",
    "should_split_pieces",
]
