"""The optimizer and the converter on the xLSTM, VLM and encoder-decoder
parameter trees.

``stacked_groups`` makes each ``encoder.stack.<layer>`` leaf one stacked
group of ``encoder_layers`` tensors, so AdamW decays the stacked encoder
norms ``(encoder_layers, d)`` as the reference does.  One AdamW update on
the reduced seamless and the reduced xlstm (its sLSTM's stacked ``r`` is
5-D) and one Adafactor update on the reduced qwen2-vl match the
reference's within ``1e-6 * max|leaf|`` (``tests/port_family.py``).
``params_from_jax`` refuses a missing ``encoder.*`` or ``cross.*`` leaf
and an encoder stack of the wrong depth; ``stacked_params`` and
``load_stacked`` go both ways.
"""

import re

import numpy as np
import pytest
import torch

import port_family as PF
import port_threads  # noqa: F401  (one torch thread a worker)
from repro_torch.models.convert import (flatten_tree, load_stacked, params_from_jax,
                                        stacked_params)
from repro_torch.optim import optimizer as TO

SEAMLESS, XLSTM, VLM = "seamless-m4t-large-v2", "xlstm-350m", "qwen2-vl-72b"


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DISABLE", "1")


@pytest.fixture(scope="module")
def trees():
    """Each architecture's reduced parameters as the reference's tree."""
    return {arch: PF.init_params(arch, 0) for arch in (SEAMLESS, XLSTM, VLM)}


def test_encoder_stack_is_one_stacked_group(trees):
    model = PF.port_model({"arch": SEAMLESS, "params": trees[SEAMLESS]})
    groups = TO.stacked_groups(dict(model.named_parameters()))
    layers = model.cfg.encoder_layers
    assert groups["encoder.stack.l0.norm1.w"] == [f"encoder.stack.{k}.l0.norm1.w"
                                                 for k in range(layers)]
    assert groups["encoder.final_norm.w"] == ["encoder.final_norm.w"]
    assert groups["stack.l0.cross.wq"] == [f"stack.{k}.l0.cross.wq"
                                           for k in range(model.cfg.n_periods)]
    assert TO.is_stacked("encoder.stack.l0.norm1.w") and not TO.is_stacked("encoder.final_norm.w")
    state = TO.make_optimizer("adamw", TO.warmup_cosine(1e-2, 2, 10)).init(
        dict(model.named_parameters()))
    assert state["m"]["encoder.stack.l0.norm1.w"].shape == (layers, model.cfg.d_model)


@pytest.mark.parametrize("arch,kind", [(SEAMLESS, "adamw"), (XLSTM, "adamw"),
                                       (VLM, "adafactor")])
def test_optimizer_update_matches_jax(trees, arch, kind):
    PF.check_optimizer_update({"arch": arch, "params": trees[arch]}, kind)


@pytest.mark.parametrize("arch", [SEAMLESS, XLSTM])
def test_stacked_params_round_trip(trees, arch):
    model = PF.port_model({"arch": arch, "params": trees[arch]})
    flat = flatten_tree(trees[arch])
    got = stacked_params(model)
    assert sorted(got) == sorted(flat)
    for name, want in flat.items():
        np.testing.assert_array_equal(got[name].numpy(), want)
    other = PF.port_model({"arch": arch, "params": trees[arch]})
    with torch.no_grad():
        for p in other.parameters():
            p.zero_()
    load_stacked(other, got)
    for (name, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("drop", ["encoder.final_norm.w", "encoder.stack.l0.ffn.w2",
                                  "stack.l0.cross.wv", "stack.l0.norm_x.w"])
def test_params_from_jax_refuses_a_missing_leaf(trees, drop):
    cfg, _ = PF.cfgs(SEAMLESS)
    flat = flatten_tree(trees[SEAMLESS])
    assert drop in flat
    del flat[drop]
    with pytest.raises(ValueError, match=f"missing.*{re.escape(drop)}"):
        params_from_jax(cfg, PF.nest(flat), device="cpu")


def test_params_from_jax_refuses_a_wrong_encoder_depth(trees):
    cfg, _ = PF.cfgs(SEAMLESS)
    flat = flatten_tree(trees[SEAMLESS])
    name = "encoder.stack.l0.mixer.wq"
    flat[name] = np.concatenate([flat[name], flat[name][:1]])
    with pytest.raises(ValueError, match="encoder_layers=2"):
        params_from_jax(cfg, PF.nest(flat), device="cpu")
