"""The port's autotuner and cost model against the JAX package's.

First the reference's ``tests/test_autotune.py`` cases against the port:
the disk cache (hit, refresh, stale on an artifact, torch-version or
constants change), the measured overlay (only when it covers every
candidate, only ``compiled: true`` rows of the deciding device, never the
reference's ``BENCH_maps.json``), the disable switch, the split rule and
the attention guards.  Then, with the port's constants and model tile
set to the reference's values, the cost model, the candidates, the split
rule and the CPU picks equal the reference's.
"""

import doctest
import json

import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.autotune import tuner as RT
from repro.kernels.policy import TPU_LANE, TPU_SUBLANE
from repro.roofline import analysis as RA
from repro_torch.autotune import tuner as T
from repro_torch.core import schedule as TS
from repro_torch.kernels.flash_attention import flash_grid_steps
from repro_torch.roofline import analysis as A


@pytest.fixture()
def env(tmp_path, monkeypatch):
    """Private cache and artifact paths for both packages' tuners."""
    paths = {"cache": tmp_path / "autotune.json", "bench": tmp_path / "BENCH_torch.json"}
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(paths["cache"]))
    monkeypatch.setenv("REPRO_TORCH_BENCH_ARTIFACT", str(paths["bench"]))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "reference_autotune.json"))
    monkeypatch.setenv("REPRO_BENCH_ARTIFACT", str(tmp_path / "reference_absent.json"))
    for name in ("REPRO_TORCH_AUTOTUNE_DISABLE", "REPRO_TORCH_SPLIT_PIECES",
                 "REPRO_TORCH_ATTN_STEP_CAP", "REPRO_AUTOTUNE_DISABLE", "REPRO_SPLIT_PIECES",
                 "REPRO_ATTN_STEP_CAP"):
        monkeypatch.delenv(name, raising=False)
    T.clear_cache()
    return paths


@pytest.fixture()
def reference_constants(monkeypatch):
    """The port's model with the reference's TPU constants and tile."""
    for name in ("HBM_BW", "SELECT_S", "SMEM_READ_S", "PREDICATE_S", "LAUNCH_OVERHEAD_S",
                 "HOST_ENUM_S", "TABLE_AMORTIZE"):
        monkeypatch.setattr(A, name, getattr(RA, name))
    monkeypatch.setattr(A, "ATTN_PEAK_FLOPS", dict.fromkeys(A.ATTN_PEAK_FLOPS, RA.PEAK_FLOPS))
    monkeypatch.setattr(A, "IDLE_STEP_TRAFFIC", 1.0)
    monkeypatch.setattr(A, "LEVELS_2D", None)
    monkeypatch.setattr(A, "COMPOSITE_DECODE_LEVELS", 0)
    monkeypatch.setattr(A, "WARP_TILE_ELEMS", TPU_SUBLANE * TPU_LANE)
    assert RA.ATTN_FOLD_SELECT_S == 2 * RA.SELECT_S and RA.ATTN_GATHER_S == RA.SMEM_READ_S


def _artifact(rows):
    return json.dumps({"schema": "bench-torch/v1", "rows": rows})


def _row(m, kind, us, steps, compiled=True, device="cpu"):
    row = {"test": f"ACCUM{m}D" if m > 2 else "ACCUM", "map": kind, "m": m,
           "grid_steps": steps, "us_per_call": us, "compiled": compiled}
    if device is not None:
        row["device"] = device
    return row


def _attn_row(kind, us, steps, compiled=True, device="cuda"):
    return {"test": "ATTN", "map": kind, "m": 2, "grid_steps": steps, "us_per_call": us,
            "device": device, "compiled": compiled}


# -- the cache -----------------------------------------------------------


def test_decision_is_concrete_and_cached(env):
    d = T.choose_kind(3, 8, device="cpu")
    assert d.kind in TS.registered_kinds(3) and d.source == "model" and d.scores_us
    assert d.fingerprint == "absent" and d.torch_version == torch.__version__
    data = json.loads(env["cache"].read_text())
    assert data["schema"] == T.CACHE_SCHEMA and "m=3,n=8,device=cpu" in data["entries"]
    T._SEEN.clear()  # forget this process's copy: the hit comes from disk
    d2 = T.choose_kind(3, 8, device="cpu")
    assert (d2.source, d2.kind) == ("cache", d.kind)
    assert T.choose_kind(3, 8, device="cpu").source == "cache"


def test_cache_hit_does_not_recompute(env, monkeypatch):
    d = T.choose_kind(2, 16, device="cpu")

    def boom(*a, **k):
        raise AssertionError("scored on a cache hit")

    monkeypatch.setattr(T, "_model_scores", boom)
    monkeypatch.setattr(T, "_measured_scores", boom)
    d2 = T.choose_kind(2, 16, device="cpu")
    assert d2.source == "cache" and d2.kind == d.kind


def test_refresh_bypasses_cache(env):
    T.choose_kind(2, 16, device="cpu")
    assert T.choose_kind(2, 16, device="cpu", refresh=True).source != "cache"


def test_stale_on_bench_artifact_change(env):
    T.choose_kind(3, 8, device="cpu")
    env["bench"].write_text(_artifact([]))
    d = T.choose_kind(3, 8, device="cpu")
    assert d.source != "cache" and d.fingerprint != "absent"
    assert T.choose_kind(3, 8, device="cpu").source == "cache"


def test_stale_on_torch_version_change(env, monkeypatch):
    T.choose_kind(3, 8, device="cpu")
    monkeypatch.setattr(T, "_torch_version", lambda: "999.0.0")
    assert T.choose_kind(3, 8, device="cpu").source != "cache"


def test_stale_on_constants_change(env, monkeypatch):
    d = T.choose_kind(3, 8, device="cpu")
    T._SEEN.clear()
    assert T.choose_kind(3, 8, device="cpu").source == "cache"
    monkeypatch.setattr(A, "HBM_BW", A.HBM_BW * 2)
    d2 = T.choose_kind(3, 8, device="cpu")
    assert d2.source != "cache" and d2.constants != d.constants


def test_clear_cache(env):
    T.choose_kind(3, 8, device="cpu")
    T.clear_cache()
    assert not env["cache"].exists()
    assert T.choose_kind(3, 8, device="cpu").source == "model"


def test_disable_env_skips_cache(env, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DISABLE", "1")
    assert T.choose_kind(3, 8, device="cpu").source != "cache"
    assert T.choose_kind(3, 8, device="cpu").source != "cache"
    assert not env["cache"].exists()


def test_decisions_are_per_device(env):
    T.choose_kind(3, 8, device="cpu")
    d = T.choose_kind(3, 8, device="cuda")  # decided, never launched: no card needed
    assert d.device == "cuda" and d.source == "model"
    entries = json.loads(env["cache"].read_text())["entries"]
    assert {"m=3,n=8,device=cpu", "m=3,n=8,device=cuda"} <= set(entries)


# -- the measured overlay ----------------------------------------------------


def test_measured_rows_win(env):
    kinds = T.candidate_kinds(3, 8)
    assert "bb" in kinds
    rows = [_row(3, k, 0.001 if k == "bb" else 1000.0, TS.SimplexSchedule(3, 8, k).steps)
            for k in kinds]
    env["bench"].write_text(_artifact(rows))
    d = T.choose_kind(3, 8, device="cpu")
    assert (d.kind, d.source) == ("bb", "measured")


def test_partial_measured_coverage_keeps_model_ranking(env):
    env["bench"].write_text(_artifact([_row(3, "bb", 0.001, 8**3)]))
    assert T.choose_kind(3, 8, device="cpu").source == "model"


@pytest.mark.parametrize("row", [dict(compiled=False), dict(device="cuda"),
                                 dict(device=None)], ids=["interpret", "other", "unnamed"])
def test_rows_not_of_this_device_or_not_compiled_are_ignored(env, row):
    kinds = T.candidate_kinds(3, 8)
    rows = [_row(3, k, 0.001, TS.SimplexSchedule(3, 8, k).steps, **row) for k in kinds]
    env["bench"].write_text(_artifact(rows))
    assert T.choose_kind(3, 8, device="cpu").source == "model"


def test_reference_artifact_is_never_read(env, monkeypatch, tmp_path):
    # The JAX package's artifact holds its own compiled CPU rows; the port's
    # default artifact is its own file, resolved from the package, not cwd.
    monkeypatch.delenv("REPRO_TORCH_BENCH_ARTIFACT")
    monkeypatch.chdir(tmp_path)
    kinds = T.candidate_kinds(3, 8)
    rows = [dict(_row(3, k, 0.001, TS.SimplexSchedule(3, 8, k).steps, device=None),
                 backend="cpu") for k in kinds]
    rows += [_row(3, k, 0.001, TS.SimplexSchedule(3, 8, k).steps) for k in kinds]
    (tmp_path / "BENCH_maps.json").write_text(_artifact(rows))
    (tmp_path / "BENCH_torch.json").write_text(_artifact(rows))
    assert T.bench_artifact_path() != str(tmp_path / "BENCH_torch.json")
    d = T.choose_kind(3, 8, device="cpu", refresh=True)
    assert d.source == "model" and d.fingerprint == T._fingerprint(T.bench_artifact_path())


def test_default_paths_are_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_BENCH_ARTIFACT", raising=False)
    assert T.cache_path().endswith("build/repro_torch/autotune.json")
    assert T.bench_artifact_path().endswith("BENCH_torch.json")
    assert "repro-simplex" not in T.cache_path()


# -- kinds, split ----------------------------------------------------------


def test_candidate_kinds_m2_excludes_linear_grid_kinds():
    for n in (8, 16, 12):
        ks = T.candidate_kinds(2, n)
        assert ks and "table" not in ks and "composite" not in ks


def test_resolve_kind_auto_is_concrete(env):
    for m, n in [(2, 16), (2, 12), (3, 8), (3, 6), (4, 4), (4, 15)]:
        for device in ("cpu", "cuda"):
            kind = TS.resolve_kind(m, n, "auto", device=device)
            assert kind in T.candidate_kinds(m, n)


def test_should_split_pieces_threshold_and_force(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_SPLIT_PIECES", raising=False)
    assert not T.should_split_pieces(2, 10**12)  # too few pieces
    assert not T.should_split_pieces(10, 100)  # the chain costs less than launches
    assert T.should_split_pieces(10, 10**12)
    # the card's launch costs more than the chain of a composite walk of
    # the paper's sizes: m=4 n=60 rho 4 (30 pieces), m=3 n=960 rho 8
    assert not T.should_split_pieces(30, 3826)
    assert not T.should_split_pieces(16, 304768)
    monkeypatch.setenv("REPRO_TORCH_SPLIT_PIECES", "1")
    assert T.should_split_pieces(2, 1)
    monkeypatch.setenv("REPRO_TORCH_SPLIT_PIECES", "0")
    assert not T.should_split_pieces(10, 10**12)


def test_model_weighs_idle_steps_by_their_map(env):
    # An idle step costs its predicate, not a tile: bb at m=2 costs the
    # tile traffic of the triangle plus a predicate per grid step.
    tri, steps = 2080, 4096
    bb = A.schedule_cost_model("bb", steps, m=2, n=64, useful=tri, rho=16)
    traffic = tri * 2 * 16 * 16 * 4 / A.HBM_BW
    assert bb == pytest.approx(traffic + steps * A.PREDICATE_S, rel=1e-12)


# -- attention -------------------------------------------------------------


def test_attn_decision_cpu_shape_is_folded_flash(env):
    d = T.choose_attn_impl(64, 4, 16, device="cpu")
    assert (d.impl, d.kind, d.block_q, d.source) == ("flash", "folded", 32, "model")
    assert set(d.scores_us) == {"folded", "bb", "chunked"}
    data = json.loads(env["cache"].read_text())
    assert "attn,s=64,h=4,d=16,dtype=float32,device=cpu" in data["entries"]
    assert T.choose_attn_impl(64, 4, 16, device="cpu").source == "cache"


@pytest.mark.parametrize("seq,dtype,block", [(2048, torch.float32, 128),
                                             (2048, torch.bfloat16, 128),
                                             (2080, torch.bfloat16, 32)])
def test_attn_decision_serve_shape_on_the_card_is_folded_flash(env, seq, dtype, block):
    d = T.choose_attn_impl(seq, 32, 128, device="cuda", dtype=dtype)
    assert (d.impl, d.kind, d.block_q, d.source) == ("flash", "folded", block, "model")
    assert d.scores_us["folded"] < d.scores_us["bb"] < d.scores_us["chunked"]


def test_attn_step_cap_on_the_cpu_only(env, monkeypatch):
    d = T.choose_attn_impl(4096, 32, 128, device="cpu")
    assert (d.impl, d.source) == ("chunked", "fallback")
    assert T.choose_attn_impl(4096, 32, 128, device="cuda").impl == "flash"
    monkeypatch.setenv("REPRO_TORCH_ATTN_STEP_CAP", "10000000")
    assert T.choose_attn_impl(4096, 32, 128, device="cpu", refresh=True).impl == "flash"


def test_attn_unmappable_seq_falls_back(env):
    d = T.choose_attn_impl(100, 4, 16, device="cpu")
    assert (d.impl, d.kind, d.block_q, d.source) == ("chunked", "chunked", 0, "fallback")


def test_attn_measured_rows_win_and_partial_keeps_model(env):
    heads, nq = 32, 16
    steps_f = heads * flash_grid_steps(nq, "folded")
    steps_b = heads * flash_grid_steps(nq, "bb")
    env["bench"].write_text(_artifact([_attn_row("chunked", 10.0, steps_f)]))
    assert T.choose_attn_impl(2048, heads, 128, device="cuda").source == "model"
    env["bench"].write_text(_artifact([
        _attn_row("folded", 500.0, steps_f), _attn_row("bb", 600.0, steps_b),
        _attn_row("chunked", 10.0, steps_f)]))
    d = T.choose_attn_impl(2048, heads, 128, device="cuda")
    assert (d.impl, d.kind, d.source) == ("chunked", "chunked", "measured")
    env["bench"].write_text(_artifact([
        _attn_row(k, 1.0, 1000, compiled=False) for k in ("folded", "bb", "chunked")]))
    assert T.choose_attn_impl(2048, heads, 128, device="cuda").source == "model"


# -- the reference's model under the reference's constants -------------------

MODEL_ARGS = [
    dict(steps=136, m=2, n=16, useful=136),
    dict(steps=256, m=2, n=16, useful=136, rho=16, dtype_bytes=2),
    dict(steps=424096, m=3, n=128, useful=357760, pieces=1, rho=8),
    dict(steps=304768, m=3, n=120, useful=295240, pieces=16, rho=8, hbm_bw=1e12),
    dict(steps=3826, m=4, n=15, useful=3060, pieces=30, rho=4, dtype_bytes=8),
]
ATTN_ARGS = [
    dict(steps=32 * 136, m=2, n=16, useful=32 * 136, rho=128, head_dim=128),
    dict(steps=32 * 256, m=2, n=16, useful=32 * 136, rho=64, head_dim=64, dtype_bytes=2),
    dict(steps=4 * 18, m=2, n=5, useful=4 * 15, rho=32),
]


@pytest.mark.parametrize("args", MODEL_ARGS)
@pytest.mark.parametrize("kind", ["hmap", "octant", "rb", "bb", "table", "composite"])
def test_cost_model_equals_reference(reference_constants, kind, args):
    want = RA.schedule_cost_model(kind, **args)
    assert A.schedule_cost_model(kind, **args) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("args", ATTN_ARGS)
@pytest.mark.parametrize("kind", ["attn-folded", "attn-bb", "attn-chunked"])
def test_attention_cost_model_equals_reference(reference_constants, kind, args):
    want = RA.schedule_cost_model(kind, **args)
    assert A.schedule_cost_model(kind, **args) == pytest.approx(want, rel=1e-12)
    with pytest.raises(ValueError, match="unknown attention"):
        A.schedule_cost_model("attn-nope", **args)


@pytest.mark.parametrize("m", [2, 3, 4, 5, 6])
def test_candidate_kinds_equal_reference(m):
    for n in range(2, 41):
        assert T.candidate_kinds(m, n) == RT.candidate_kinds(m, n), (m, n)


def test_should_split_pieces_equals_reference(reference_constants, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_SPLIT_PIECES", raising=False)
    monkeypatch.delenv("REPRO_SPLIT_PIECES", raising=False)
    for pieces in (1, 2, 3, 4, 16, 91):
        for steps in (1, 100, 3333, 3334, 10**4, 10**6, 10**9):
            assert T.should_split_pieces(pieces, steps) == RT.should_split_pieces(
                pieces, steps), (pieces, steps)


def test_model_picks_equal_reference_on_the_cpu(env, reference_constants):
    for m, n in [(2, 4), (2, 16), (2, 12), (2, 7), (3, 4), (3, 8), (3, 6), (3, 13),
                 (4, 4), (4, 6), (4, 15), (5, 8), (6, 5)]:
        got = T.choose_kind(m, n, device="cpu")
        want = RT.choose_kind(m, n, backend="cpu")
        assert (got.kind, got.source) == (want.kind, want.source), (m, n)
        assert got.scores_us == pytest.approx(want.scores_us, rel=1e-12)


def test_attention_picks_equal_reference_on_the_cpu(env, reference_constants):
    for seq, heads, d in [(64, 4, 16), (128, 8, 32), (256, 4, 64), (96, 2, 16),
                          (100, 4, 16), (4096, 32, 128), (1024, 2, 128)]:
        got = T.choose_attn_impl(seq, heads, d, device="cpu")
        want = RT.choose_attn_impl(seq, heads, d, backend="cpu")
        assert (got.impl, got.kind, got.block_q, got.source) == (
            want.impl, want.kind, want.block_q, want.source), (seq, heads, d)
        assert got.scores_us == pytest.approx(want.scores_us, rel=1e-12)


def test_tuner_and_model_doctests(env):
    for module in (T, A):
        result = doctest.testmod(module, verbose=False)
        assert result.failed == 0 and result.attempted > 0
