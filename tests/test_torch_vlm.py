"""qwen2-vl-72b in the port against the JAX package: M-RoPE and patch
embeddings.

``mrope`` alone at the full config's sections (16, 24, 24) over head
dim 128, on random (t, h, w) positions, and ``attn_apply`` with M-RoPE
(prefill and decode) at the reduced config, each within ``1e-5 + 1e-5 *
max|y|``; the model's M-RoPE positions of patches and text equal the
reference's.  Then the reduced qwen2-vl with 16 patch embeddings
prepended to 32 text tokens: prefill (logits and caches), two greedy
decode steps at the reference's positions (all three streams at the
absolute position), ``Model.loss`` on the text positions and every
gradient, within the tolerances of ``tests/port_family.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_family as PF
import port_threads  # noqa: F401  (one torch thread a worker)
from repro.configs import qwen2_vl_72b as RQ
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models.model import Model as RModel
from repro_torch.configs import qwen2_vl_72b as TQ
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.model import Model

ARCH = "qwen2-vl-72b"
# ArchConfig.param_count of FULL in the JAX package
FULL_PARAMS = 72_705_384_448


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DISABLE", "1")


def test_config_is_the_reference_field_for_field():
    PF.check_config(TQ, RQ, FULL_PARAMS)
    assert sum(TQ.FULL.mrope_sections) == TQ.FULL.hd // 2 == 64
    assert TQ.FULL.n_patches == 32 * 32


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_mrope_matches_jax_at_the_full_sections(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 10, 128)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (2, 10, 3)).astype(np.int32)
    sections = TQ.FULL.mrope_sections
    got = TL.mrope(torch.from_numpy(x), torch.from_numpy(pos3), sections, theta)
    want = RL.mrope(jnp.asarray(x), jnp.asarray(pos3), sections, theta)
    PF.module_close(got, want)
    # with the three streams equal, M-RoPE is RoPE at that position
    same = np.repeat(pos3[..., :1], 3, axis=-1)
    np.testing.assert_array_equal(
        TL.mrope(torch.from_numpy(x), torch.from_numpy(same), sections, theta).numpy(),
        TL.rope(torch.from_numpy(x), torch.from_numpy(same[..., 0]), theta).numpy())
    with pytest.raises(ValueError, match="sections"):
        TL.mrope(torch.from_numpy(x), torch.from_numpy(pos3), (16, 24, 23), theta)


def test_mrope_positions_are_the_reference_s():
    tcfg, rcfg = PF.cfgs(ARCH)
    model = Model(tcfg, device="meta")
    for s in (tcfg.n_patches, tcfg.n_patches + 1, tcfg.n_patches + 9):
        want = np.asarray(RModel(rcfg)._mrope_positions(2, s))
        got = model._mrope_positions(s, "cpu")[None].expand(2, s, 3)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_attn_apply_with_mrope_matches_jax():
    tcfg, rcfg = PF.cfgs(ARCH)
    p = TA.attn_init(torch.Generator().manual_seed(2), tcfg)
    params = {k: jnp.asarray(v.numpy()) for k, v in p.state_dict().items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    pos3 = rng.integers(0, 40, (2, 12, 3)).astype(np.int32)
    apply = jax.jit(RA.attn_apply, static_argnums=1, static_argnames="mode")
    out, cache = TA.attn_apply(p, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                               mode="prefill", positions3=torch.from_numpy(pos3))
    rout, rcache = apply(params, rcfg, jnp.asarray(x), jnp.asarray(pos), mode="prefill",
                         positions3=jnp.asarray(pos3))
    PF.module_close(out, rout)
    for got, want in zip(cache, rcache):
        PF.module_close(got, want)
    x1, p1 = x[:, :1], np.full((2, 1), 40, np.int32)
    p13 = np.full((2, 1, 3), 40, np.int32)
    dec, _ = TA.attn_apply(p, tcfg, torch.from_numpy(x1), torch.from_numpy(p1), cache=cache,
                           mode="decode", positions3=torch.from_numpy(p13))
    rdec, _ = apply(params, rcfg, jnp.asarray(x1), jnp.asarray(p1), cache=rcache,
                    mode="decode", positions3=jnp.asarray(p13))
    PF.module_close(dec, rdec)


@pytest.fixture(scope="module")
def ref():
    return PF.reference(ARCH)


def test_reduced_prefill_and_decode_match_jax(ref):
    assert ref["extra"]["patches"].shape == (PF.B, 16, 64)
    assert ref["steps"][0][1][0] == 16 + PF.S
    PF.check_served(ref)


def test_reduced_loss_and_grads_match_jax(ref):
    PF.check_loss_and_grads(ref)


def test_patches_change_the_text_logits(ref):
    """The patches reach the text: without them the same tokens give other
    logits (and no M-RoPE positions)."""
    model = PF.port_model(ref)
    tokens = torch.from_numpy(ref["tokens"][:, :PF.S]).long()
    with_patches, _ = model.prefill({"tokens": tokens, **PF.torch_extra(ref)})
    without, _ = model.prefill({"tokens": tokens})
    assert not torch.allclose(with_patches, without, rtol=1e-2, atol=1e-2)
