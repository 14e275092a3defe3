"""Training jamba-v0.1-52b, deepseek-v3-671b, xlstm-350m, qwen2-vl-72b
and seamless-m4t-large-v2 at their reduced configs on the CPU:
``launch/train.py``'s ``build`` and ``run`` for two steps on one repeated
batch, frame embeddings and patch embeddings given through ``run``'s
``batch_at``; and ``chip_smoke.py``'s full-width train rows of the same
five families, their cuts and their memory reckoned on the meta device.
No JAX: the reduced models' losses and gradients are held against the
reference in each family's own test file."""

import dataclasses
import importlib.util
import math
import pathlib

import port_threads  # noqa: F401  (one torch thread a worker)
import pytest
import torch

from repro_torch.configs import ALL as configs
from repro_torch.configs.ALL import config
from repro_torch.launch import train
from repro_torch.models.model import Model
from repro_torch.optim.optimizer import make_optimizer, warmup_cosine

FAMILIES = ("jamba-v0.1-52b", "deepseek-v3-671b", "xlstm-350m", "qwen2-vl-72b",
            "seamless-m4t-large-v2")
# The optimizer each family's config names, and the state keys it keeps.
OPTIMIZERS = {"jamba-v0.1-52b": "adafactor", "deepseek-v3-671b": "adafactor",
              "xlstm-350m": "adamw", "qwen2-vl-72b": "adafactor",
              "seamless-m4t-large-v2": "adamw"}
STATE_KEYS = {"adamw": {"m", "v", "gnorm"}, "adafactor": {"f", "gnorm"}}
BATCH, SEQ, STEPS = 2, 32, 2
REPO = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_rows", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
NEW_ROWS = [r for r in CS.TRAIN_RUNS if r.arch in FAMILIES]


def _args(arch, steps=STEPS):
    return train.parse_args(["--arch", arch, "--smoke", "--device", "cpu", "--batch", str(BATCH),
                             "--seq", str(SEQ), "--steps", str(steps), "--log-every", "1",
                             "--seed", "3"])


def _batch(t):
    """The trainer's first batch, with what the family's loss reads
    besides the tokens: frame embeddings for the encoder, patch embeddings
    in front of a shorter text for the VLM (SEQ positions either way)."""
    cfg = t.model.cfg
    fixed = t.data.batch_at(0)
    g = torch.Generator().manual_seed(5)
    if cfg.encoder_layers:
        fixed["src_embeds"] = torch.randn((BATCH, SEQ, cfg.d_model), generator=g)
    if cfg.n_patches:
        fixed["tokens"] = fixed["tokens"][:, :SEQ - cfg.n_patches + 1]
        fixed["patches"] = torch.randn((BATCH, cfg.n_patches, cfg.d_model), generator=g)
    return fixed


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_trains_through_build_and_run(arch):
    args = _args(arch)
    t = train.build(args)
    cfg = t.model.cfg
    assert (cfg.act_dtype, cfg.param_dtype, cfg.remat) == ("float32", "float32", "none")
    assert cfg.optimizer == OPTIMIZERS[arch]
    assert set(t.opt_state) == STATE_KEYS[cfg.optimizer]
    fixed = _batch(t)
    assert ("src_embeds" in fixed) == (arch == "seamless-m4t-large-v2")
    assert ("patches" in fixed) == (arch == "qwen2-vl-72b")
    with torch.no_grad():
        want = float(t.model.loss(fixed)[0])
    seen = []

    def batch_at(step):
        seen.append(step)
        return fixed

    train.run(args, t, batch_at=batch_at)
    assert seen == list(range(STEPS))
    assert t.losses[0] == want  # the first logged loss is Model.loss's, bit for bit
    assert all(math.isfinite(x) for x in t.losses + t.grad_norms)
    assert t.losses[-1] < t.losses[0]
    assert len(t.step_s) == STEPS
    if cfg.moe:
        assert all(a > 0 for a in t.aux)
    if cfg.mtp:  # the MTP head's share: total - ce - aux
        assert all(x - c - a > 0 for x, c, a in zip(t.losses, t.ce, t.aux))


def test_build_trains_a_callers_cut_config():
    """``build(args, cfg=...)`` trains the caller's cut (here fewer
    experts and one dense prefix layer, as the card's deepseek-v3 row),
    with the trainer's float32 and remat overrides applied to it."""
    red = config("deepseek-v3-671b", smoke=True)
    cut = red.replace(n_layers=2, n_prefix=1, prefix_spec=red.prefix_spec[:1],
                      moe=dataclasses.replace(red.moe, n_experts=4))
    t = train.build(_args("deepseek-v3-671b", steps=1), cfg=cut)
    cfg = t.model.cfg
    assert (cfg.n_layers, cfg.n_prefix, cfg.moe.n_experts) == (2, 1, 4)
    assert (cfg.act_dtype, cfg.remat) == ("float32", "none")
    assert sum(p.numel() for p in t.model.parameters()) == cut.param_count()
    train.run(_args("deepseek-v3-671b", steps=1), t, batch_at=lambda step: _batch(t))
    assert math.isfinite(t.losses[0])


def test_entry_points_default_to_the_card():
    """``Model`` and ``build`` take the card when no device is given (and
    raise here, where there is none); an optimizer's state lies where the
    parameters lie."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(config("xlstm-350m", smoke=True))
    args = train.parse_args(["--arch", "xlstm-350m", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.build(args)
    params = {"w": torch.empty((4, 3), device="meta"), "b": torch.empty((3,), device="meta")}
    for kind in ("adamw", "adafactor"):
        state = make_optimizer(kind, warmup_cosine(1e-3, 1, 10)).init(params)
        leaves = [state["gnorm"]] + [x for v in state.values() if isinstance(v, dict)
                                     for y in v.values()
                                     for x in (y.values() if isinstance(y, dict) else [y])]
        assert leaves and all(x.device.type == "meta" for x in leaves)


@pytest.mark.parametrize("row", NEW_ROWS, ids=lambda r: r.arch)
def test_train_row_reckoned_under_the_line(row):
    """``chip_smoke.py``'s train row of each family, at full width with
    its cuts, reckoned on the meta device under the 75 GiB line."""
    cfg = CS.train_config(configs, row)
    full = configs.config(row.arch)
    assert (cfg.d_model, cfg.n_heads, cfg.vocab) == (full.d_model, full.n_heads, full.vocab)
    reck = CS.train_reckoning(cfg, row.batch, row.seq, row.flash)
    assert reck["params"] == cfg.param_count()
    assert reck["weights"] == pytest.approx(4 * reck["params"] / 2**30)
    assert reck["activations"] > 0 and reck["temps"] > 0
    assert reck["peak"] == max(reck["backward"], reck["update"])
    assert reck["peak"] < CS.TRAIN_PEAK_GIB


def test_new_train_rows_and_their_cuts():
    rows = {r.arch: r for r in NEW_ROWS}
    assert set(rows) == set(FAMILIES)
    for arch in FAMILIES:
        row, full = rows[arch], config(arch)
        cfg = CS.train_config(configs, row)
        assert row.why and row.steps in (3, CS.TRAIN_STEPS)
        if full.moe:  # the expert cut, named, top-k kept
            assert 0 < row.experts < full.moe.n_experts and "experts" in row.why
            assert (cfg.moe.n_experts, cfg.moe.top_k) == (row.experts, full.moe.top_k)
        else:
            assert row.experts == 0 and cfg.moe is None
    deepseek = CS.train_config(configs, rows["deepseek-v3-671b"])
    full = config("deepseek-v3-671b")
    assert (deepseek.n_prefix, deepseek.prefix_spec, deepseek.n_periods) == (
        1, full.prefix_spec[:1], 1)
    assert deepseek.mtp and deepseek.moe.router == "sigmoid"
    jamba = CS.train_config(configs, rows["jamba-v0.1-52b"])
    assert jamba.n_periods == 1 and sum(s.mixer == "attn" for s in jamba.period) == 1
    # the flash layers a forward pass: attention layers of a kernel head dim,
    # decoder self-attention only (MLA and xLSTM take none)
    assert [rows[a].flash for a in FAMILIES] == [1, 0, 0, 2, 24]
    assert CS.train_config(configs, rows["qwen2-vl-72b"]).n_layers == 2
    assert rows["seamless-m4t-large-v2"].inputs == "src_embeds"
    assert rows["qwen2-vl-72b"].inputs == "patches"


