"""Rules of ``chip_smoke.py`` that need no card, loaded by path: the
earlier train rows' memory reckoning on the ``meta`` device and the
extrapolation it makes for a sequential mixer, the turn-taking timer's
rounds (the tuner phase's simplex and attention cases) and the flash
launch grid its attention lines log.  The five families' rows are
reckoned in ``test_torch_train_families.py``."""

import importlib.util
import math
import pathlib

import port_threads  # noqa: F401  (one torch thread a worker)
import pytest

from repro_torch.configs import ALL as configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import mamba

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke_rules", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load()
NEW_ROWS = ("jamba-v0.1-52b", "deepseek-v3-671b", "xlstm-350m", "qwen2-vl-72b",
            "seamless-m4t-large-v2")


@pytest.mark.parametrize("row", [r for r in CS.TRAIN_RUNS if r.arch not in NEW_ROWS],
                         ids=lambda r: f"{r.arch}-{r.remat}")
def test_earlier_train_row_reckoned_under_the_line(row):
    """The train rows before the five families: the same reckoning and line."""
    cfg = CS.train_config(configs, row)
    full = configs.config(row.arch)
    assert (cfg.d_model, cfg.n_heads, cfg.vocab) == (full.d_model, full.n_heads, full.vocab)
    reck = CS.train_reckoning(cfg, row.batch, row.seq, row.flash)
    assert reck["params"] == cfg.param_count()
    assert reck["weights"] == pytest.approx(4 * reck["params"] / 2**30)
    assert reck["activations"] > 0 and reck["temps"] > 0
    assert reck["peak"] == max(reck["backward"], reck["update"])
    assert reck["peak"] < CS.TRAIN_PEAK_GIB


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-v0.1-52b"])
def test_reckoned_activations_extrapolate_from_two_chunks(arch, monkeypatch):
    """A sequential mixer's saved bytes, counted at one and two scan
    chunks and extrapolated, are the count at the full length or a little
    above it (xLSTM's grow a little less than linearly)."""
    import torch

    from repro_torch.models.model import Model

    monkeypatch.setattr(mamba, "SCAN_CHUNK", 16)
    cfg = configs.config(arch, smoke=True).replace(act_dtype="float32", param_dtype="float32",
                                                   remat="none")
    seq = 64
    got = CS.train_reckoning(cfg, 2, seq)["activations"] * 2**30
    model = Model(cfg, device="meta").requires_grad_(True)
    tokens = torch.zeros((2, seq + 1), dtype=torch.long, device="meta")
    want = CS.saved_bytes(model, {"tokens": tokens})
    assert want <= got <= 1.05 * want


def test_tuner_rounds_rule():
    # simplex cases: 9 rounds of 5 ms samples, 101 where launch-bound
    rounds, calls = CS.tuner_rounds({"hmap": 0.55, "bb": 0.6})
    assert (rounds, calls) == (CS.TUNER_ROUNDS, {"hmap": 10, "bb": 9}) and rounds == 9
    rounds, calls = CS.tuner_rounds({"hmap": 0.03, "table": 0.5})
    assert rounds == CS.TUNER_ROUNDS_LAUNCH_BOUND == 101
    assert calls == {"hmap": math.ceil(5.0 / 0.03), "table": 10}
    assert CS.tuner_rounds({"x": 1e-6})[1] == {"x": CS.TUNER_MAX_CALLS}
    assert CS.tuner_rounds({"x": 1e-6}, attention=True)[1] == {"x": CS.TUNER_MAX_CALLS}
    # attention cases: more rounds of longer samples, whatever the call time
    for one in ({"flash-folded": 0.79, "flash-bb": 0.92, "chunked": 3.4},
                {"flash-folded": 2.4, "flash-bb": 2.4, "chunked": 12.6}):
        rounds, calls = CS.tuner_rounds(one, attention=True)
        assert rounds == CS.ATTN_TUNER_ROUNDS > CS.TUNER_ROUNDS_LAUNCH_BOUND / 3
        for key, ms in one.items():
            assert calls[key] * ms >= CS.ATTN_TUNER_SAMPLE_MS > CS.TUNER_SAMPLE_MS
            assert calls[key] == 1 or (calls[key] - 1) * ms < CS.ATTN_TUNER_SAMPLE_MS
    assert CS.tuner_rounds({"flash-folded": 0.8}, attention=True)[1] == {"flash-folded": 25}


def test_flash_grid_is_the_launchers():
    b, hq, hkv, s = 4, 32, 4, 2048
    # folded: one block a (batch, head) and pair row of tiles; bb a tile row
    assert CS.flash_grid("flash16_wgmma", "folded", 128, b, hq, hkv, s, None) == (
        b * hq * fa.flash_fold_pairs(s // 128)) == 1024
    assert CS.flash_grid("flash16_wgmma", "bb", 128, b, hq, hkv, s, None) == b * hq * 16
    # flash16 stacks 64 / block_q heads of a group in a warpgroup
    assert CS.flash_grid("flash16", "folded", 32, b, hq, hkv, 2080, 2) == (
        b * hkv * 2 * fa.flash_fold_pairs(2080 // 32))
    assert CS.flash_grid("flash16", "bb", 8, b, hq, hkv, 2048, 1) == b * hkv * 1 * 256
