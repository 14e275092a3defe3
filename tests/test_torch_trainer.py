"""The port's trainer end to end on the CPU (``launch/train.py``).

* A run interrupted by a checkpoint and resumed gives the uninterrupted
  run's losses bit for bit (stateless data, atomic checkpoints), as the
  reference's ``tests/test_substrate.py`` holds its own trainer.
* A checkpoint that the JAX package's ``checkpointing.save`` wrote for
  reduced internlm2-20b (Adafactor, two periods), its parameters and
  optimizer state after one JAX step, restores into the port's trainer:
  the loss on the next batch within ``1e-5`` relative of JAX's, and the
  next step's parameters and state within ``1e-4 * max|leaf| + 1e-7`` of
  JAX's (one more backward in float32 before the update).
* The example's ``smoke`` preset lowers the loss in a short run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)
from repro.checkpoint import checkpointing as RC
from repro.configs.ALL import REDUCED as R_REDUCED
from repro.models.model import Model as RModel
from repro.optim.optimizer import make_optimizer, warmup_cosine
from repro_torch.examples import train_lm
from repro_torch.launch import train
from repro_torch.models.convert import flatten_tree, stacked_params

ARGS = ["--arch", "yi-6b", "--smoke", "--seq", "32", "--batch", "4", "--lr", "1e-3",
        "--device", "cpu", "--log-every", "100"]


@pytest.fixture(autouse=True)
def _hermetic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DISABLE", "1")
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


@pytest.mark.parametrize("microbatches", ["1", "2"])
def test_train_restart_is_bit_exact(tmp_path, microbatches):
    args = ARGS + ["--microbatches", microbatches]
    full = train.main(args + ["--steps", "6"])
    train.main(args + ["--steps", "3", "--schedule-steps", "6", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "3"])
    resumed = train.main(args + ["--steps", "6", "--ckpt-dir", str(tmp_path), "--resume",
                                 "--ckpt-every", "100"])
    assert len(full) == 6 and len(resumed) == 3
    assert resumed == full[3:]
    assert full[-1] < full[0]


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    arch, seq, batch, lr = "internlm2-20b", 32, 2, 1e-2
    over = dict(act_dtype="float32", param_dtype="float32", remat="none")
    rcfg = R_REDUCED[arch]().replace(**over)
    rmodel = RModel(rcfg)
    opt = make_optimizer(rcfg.optimizer, warmup_cosine(lr, 1, 4))
    rng = np.random.default_rng(5)
    tok = [rng.integers(0, rcfg.vocab, (batch, seq + 1)).astype(np.int32) for _ in range(2)]

    @jax.jit
    def step(params, state, i, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: rmodel.loss(p, {"tokens": tokens})[0])(params)
        params, state = opt.update(grads, state, params, i)
        return params, state, loss

    params = jax.jit(rmodel.init)(jax.random.PRNGKey(2))
    params, state, _ = step(params, opt.init(params), jnp.asarray(0), jnp.asarray(tok[0]))
    RC.save(str(tmp_path), 1, {"params": params, "opt": state})
    params2, state2, loss1 = step(params, state, jnp.asarray(1), jnp.asarray(tok[1]))

    args = train.parse_args(["--arch", arch, "--smoke", "--seq", str(seq), "--batch", str(batch),
                             "--lr", str(lr), "--steps", "4", "--ckpt-dir", str(tmp_path),
                             "--resume", "--device", "cpu"])
    t = train.build(args)
    assert t.step0 == 1 and t.model.cfg.optimizer == "adafactor"
    loss = train.train_step(t, 1, {"tokens": torch.from_numpy(tok[1]).long()})
    assert abs(loss.item() - float(loss1)) <= 1e-5 * abs(float(loss1))
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, {"params": params2, "opt": state2}))
    got = flatten_tree({"params": {k: v.detach().numpy() for k, v in
                                   stacked_params(t.model).items()},
                        "opt": jax.tree_util.tree_map(lambda x: x.numpy(),
                                                      train._nest(t.opt_state))})
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        err = np.abs(got[name] - w).max()
        assert got[name].shape == w.shape and err <= 1e-4 * np.abs(w).max() + 1e-7, (name, err)


def test_checkpoint_holds_the_reference_tree(tmp_path):
    """What the port's trainer saves is the JAX trainer's tree: stacked
    block leaves, the optimizer state under the reference's names."""
    train.main(ARGS + ["--steps", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    rcfg = R_REDUCED["yi-6b"]().replace(act_dtype="float32", param_dtype="float32")
    proto_params = jax.eval_shape(RModel(rcfg).init, jax.random.PRNGKey(0))
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 1, 1))
    proto = {"params": proto_params, "opt": jax.eval_shape(opt.init, proto_params)}
    got, step = RC.restore_latest(str(tmp_path), jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), proto))
    assert step == 1
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(proto)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert os.path.exists(tmp_path / "step_00000001" / "params__stack__l0__mixer__wq.npy")


def test_example_smoke_preset_lowers_the_loss(tmp_path, capsys):
    losses = train_lm.main(["--preset", "smoke", "--steps", "20", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 20 and losses[-1] < losses[0] - 0.3
    assert "LEARNING" in capsys.readouterr().out
    with pytest.raises(ValueError, match="preset"):
        train_lm.preset_argv("1b")
    assert "--microbatches" in train_lm.preset_argv("100m")


def test_trainer_needs_gradients():
    t = train.build(train.parse_args(ARGS + ["--steps", "1"]))
    assert all(p.requires_grad for p in t.model.parameters())
    t.model.requires_grad_(False)
    with pytest.raises(ValueError, match="requires_grad_"):
        train.loss_and_grads(t.model, t.data.batch_at(0))
