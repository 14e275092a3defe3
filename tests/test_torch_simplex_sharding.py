"""The port's simplex sharding (``repro_torch.distributed``) on the CPU
against the JAX package's.

The partition, the skews, the shard tables and the ownership masks are
host numpy on both sides and must agree bit for bit.  The engine's
``schedule=shard`` runs each body's plain version over a shard, held
against the JAX oracles (``repro.kernels.ref``) restricted to the blocks
the reference's ``ShardSchedule.owned_block_mask()`` names; the sharded
CA's engine executor against those oracles over 1 and 3 generations
(states drawn on the domain, as the reference's tests draw them: the
oracle zeroes off-domain cells where the engine keeps its input), and
one small case against the JAX ``sharded_ca`` itself (interpret mode).
Then the watchdog and the heartbeat files, as the JAX package's own
tests drive them.
"""

import tempfile
import time

import jax
import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.core.schedule import SimplexSchedule as RSched
from repro.distributed import simplex_sharding as RSS
from repro.kernels import ref as R
from repro_torch.checkpoint import checkpointing as TC
from repro_torch.core import schedule as TS
from repro_torch.distributed import fault_tolerance as TF
from repro_torch.distributed import simplex_sharding as TSS
from repro_torch.kernels import engine as TE

# The bases of the reference's test_shard_tables_cover_base.
TABLE_CASES = [(2, 16, "hmap"), (2, 16, "rb"), (2, 12, "composite"), (3, 8, "table"),
               (3, 8, "octant"), (3, 12, "composite"), (4, 4, "table")]


# The JAX oracles, jitted: one compile a shape instead of one per operation.
MASK = jax.jit(R.simplex_mask, static_argnums=(0, 1))
EDM = jax.jit(R.edm_md, static_argnums=1)
CA = {2: jax.jit(R.ca2d_step), 3: jax.jit(R.ca_md_step), 4: jax.jit(R.ca_md_step)}


def _state(m, n, seed):
    rng = np.random.default_rng(seed)
    s = (rng.random((n,) * m) < 0.4).astype(np.int32)
    return np.where(np.asarray(MASK(m, n)), s, 0).astype(np.int32)


def _oracle(state, steps):
    for _ in range(steps):
        state = np.asarray(CA[state.ndim](state))
    return state


def _owned(sh, rho):
    """The reference shard's ownership, element-sized."""
    blk = sh.owned_block_mask()
    for ax in range(blk.ndim):
        blk = np.repeat(blk, rho, axis=ax)
    return blk


# ---------------------------------------------------------------- partition


@pytest.mark.parametrize("S", [1, 2, 5, 6, 17, 36, 120, 136, 529, 4097])
def test_fold_partition_is_the_reference(S):
    for k in (1, 2, 3, 4, 7, 8, 16):
        if k > S:
            with pytest.raises(ValueError):
                TSS.fold_partition(S, k)
            continue
        ours, ref = TSS.fold_partition(S, k), RSS.fold_partition(S, k)
        assert [(s.index, s.k, s.ranges, s.steps) for s in ours] == [
            (s.index, s.k, s.ranges, s.steps) for s in ref], (S, k)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_skews_are_the_reference(m):
    for nb in (4, 8, 16, 17, 64):
        for kind in ("hmap", "table", "composite", "bb"):
            kind = TS.resolve_kind(m, nb, kind)
            for k in (1, 2, 4, 8):
                got = TSS.shard_skew(TS.SimplexSchedule(m, nb, kind), k)
                assert got == RSS.shard_skew(RSched(m, nb, kind), k), (m, nb, kind, k)
        for k in range(1, min(nb, 9)):
            assert TSS.slab_skew(m, nb, k) == RSS.slab_skew(m, nb, k), (m, nb, k)
    with pytest.raises(ValueError):
        TSS.slab_skew(m, 4, 5)


# ------------------------------------------------------------ ShardSchedule


@pytest.mark.parametrize("m,n,kind", TABLE_CASES, ids=[f"m{m}-n{n}-{k}" for m, n, k in TABLE_CASES])
@pytest.mark.parametrize("k", [2, 4])
def test_shard_tables_and_masks_are_the_reference(m, n, kind, k):
    ours = TSS.shard_schedules(TS.SimplexSchedule(m, n, kind), k)
    ref = RSS.shard_schedules(RSched(m, n, kind), k)
    for a, b in zip(ours, ref, strict=True):
        assert (a.grid, a.steps, a.useful, a.ranges) == (b.grid, b.steps, b.useful, b.ranges)
        assert np.array_equal(a.table(), b.table())
        assert np.array_equal(a.owned_block_mask(), b.owned_block_mask())
    # the plain walk (torch) of each shard is its table
    for sh in ours:
        coords, valid = TE.walk(sh, "cpu")
        got = torch.cat([coords, valid[:, None].long()], 1).numpy()
        assert np.array_equal(got, sh.table())


def test_shard_descriptor_shares_the_base_payload():
    base = TS.SimplexSchedule(3, 6, "composite")
    shard = TSS.shard_schedules(base, 4)[1]
    got, want = shard.device_descriptor("cpu"), base.device_descriptor("cpu")
    assert got.data is want.data  # no per-shard copy of the pieces
    assert np.array_equal(got.header[:TS.SHARD_AT], want.header[:TS.SHARD_AT])
    (a0, b0), (a1, b1) = shard.ranges
    assert got.header[TS.SHARD_AT:].tolist() == [shard.steps, a0, b0 - a0, a1]
    assert want.header[TS.SHARD_AT:].tolist() == [base.steps, 0, base.steps, 0]
    assert shard.device_descriptor("cpu") is got
    with pytest.raises(ValueError):
        TS.launch_header(want.header, ((0, base.steps + 1),))
    with pytest.raises(ValueError):
        TSS.shard_schedules(TS.SimplexSchedule(3, 4, "table"), 21)  # 20 steps


# ----------------------------------------------------- engine schedule= path


@pytest.mark.parametrize("m,n,rho,kind,k", [(2, 32, 4, "hmap", 4), (2, 24, 4, "composite", 3),
                                            (3, 16, 2, "octant", 4), (3, 12, 2, "composite", 2),
                                            (4, 8, 2, "table", 2)])
def test_engine_shard_bodies_match_the_reference(m, n, rho, kind, k):
    nb = n // rho
    ours = TSS.shard_schedules(TS.SimplexSchedule(m, nb, kind), k)
    ref = RSS.shard_schedules(RSched(m, nb, kind), k)
    dom = np.asarray(MASK(m, n))
    x = _state(m, n, 3)
    p = np.random.default_rng(4).standard_normal((n, 3)).astype(np.float32)
    edm = np.asarray(EDM(p, m))
    ca = _oracle(x, 1)
    zeros = np.zeros((n,) * m, np.int32)
    total = np.zeros((n,) * m, np.int32)
    for a, b in zip(ours, ref):
        own = _owned(b, rho) & dom
        got = TE.SimplexKernel("map", m, schedule=a, device="cpu")(nb).numpy()
        assert np.array_equal(got, b.table())
        acc = TE.SimplexKernel("accum", m, rho=rho, schedule=a, device="cpu")(zeros).numpy()
        assert np.array_equal(acc, own.astype(np.int32))
        total += acc
        e = TE.SimplexKernel("edm", m, rho=rho, schedule=a, device="cpu")(p).numpy()
        np.testing.assert_allclose(e, np.where(own, edm, 0), rtol=1e-5, atol=1e-5)
        assert (e[~own] == 0).all()
        c = TE.SimplexKernel("ca", m, rho=rho, schedule=a, device="cpu")(x).numpy()
        assert np.array_equal(c, np.where(own, ca, x))
    assert np.array_equal(total, dom.astype(np.int32))


def test_engine_shard_validates_shape():
    sh = TSS.shard_schedules(TS.SimplexSchedule(3, 4, "table"), 2)[0]
    kern = TE.SimplexKernel("accum", 3, rho=2, schedule=sh, device="cpu")
    with pytest.raises(ValueError, match="explicit schedule"):  # n=16 -> nb=8 != 4
        kern(np.zeros((16, 16, 16), np.int32))
    with pytest.raises(ValueError, match="explicit schedule"):  # m=2 against a 3-simplex shard
        TE.SimplexKernel("map", 2, schedule=sh, device="cpu")(4)
    with pytest.raises(ValueError, match="explicit schedule"):
        TE.SimplexKernel("ca", 3, rho=4, schedule=sh, device="cpu")(np.zeros((8,) * 3, np.int32))


# ------------------------------------------------------------- sharded CA


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("m,n,kind,k", [(2, 32, "hmap", 4), (3, 16, "table", 2),
                                        (3, 16, "table", 4)])
def test_sharded_ca_engine_is_the_oracle(m, n, kind, k, steps):
    state = _state(m, n, 10 * m + k)
    got = TSS.sharded_ca(state, k, steps=steps, kind=kind, devices=["cpu"])
    assert got.dtype == torch.int32 and got.shape == (n,) * m
    assert np.array_equal(got.numpy(), _oracle(state, steps))


def test_sharded_ca_engine_against_the_reference_executor():
    state = _state(2, 16, 5)
    want = np.asarray(RSS.sharded_ca(state, 2, kind="hmap"))
    got = TSS.sharded_ca(state, 2, kind="hmap", devices=["cpu"])
    assert np.array_equal(got.numpy(), want)


def test_sharded_ca_round_robin_and_errors():
    state = torch.from_numpy(_state(3, 16, 6))
    runner = TSS.ShardedSimplexCA(3, 16, 4, kind="table", devices=["cpu", "cpu"])
    assert runner.rho == TE.default_rho(3) and runner.kind == "table"
    assert len(runner.ownership_masks("cpu")) == 4
    assert runner.ownership_masks("cpu")[0].shape == (4, 1, 4, 1, 4, 1)
    assert np.array_equal(runner.run(state, 2).numpy(), _oracle(state.numpy(), 2))
    with pytest.raises(ValueError, match="needs a mesh"):
        runner.step(state, executor="spmd")
    with pytest.raises(ValueError, match="unknown executor"):
        runner.step(state, executor="xla")
    with pytest.raises(ValueError, match="must divide"):
        TSS.ShardedSimplexCA(3, 18, 2)
    with pytest.raises(ValueError, match="process group"):
        TSS.shard_mesh(2, device="cpu")


def test_slab_step_is_the_oracle_on_one_slab():
    for m, n in ((2, 32), (3, 16)):
        state = torch.from_numpy(_state(m, n, 7))
        mask = TSS.slab_mask(m, n, 0, n, "cpu")
        s = torch.where(mask, state, 0)
        if m == 2:
            up, down = s[-1:], s[:1]
        else:
            up = down = torch.zeros_like(s[:1])
        got = TSS.slab_step(state, up, down, mask)
        assert np.array_equal(got.numpy(), _oracle(state.numpy(), 1))


# --------------------------------------------------------- fault tolerance


def test_watchdog_restart_resumes_from_checkpoint():
    """Simulated node failure: the run crashes twice mid-training; the
    watchdog resumes from the latest checkpoint and finishes."""
    with tempfile.TemporaryDirectory() as d:
        state = {"calls": 0, "starts": []}

        def train_fn(resume_step):
            state["calls"] += 1
            state["starts"].append(resume_step)
            step = resume_step or 0
            while step < 10:
                step += 1
                if step % 4 == 0:
                    TC.save(d, step, {"step": torch.tensor(step)})
                if state["calls"] < 3 and step == 4 * state["calls"] + 1:
                    raise RuntimeError("simulated node failure")

        restarts = TF.watchdog_restart(train_fn, d, max_restarts=5)
        assert restarts == 2
        assert TC.latest_step(d) == 8
        assert state["starts"] == [None, 4, 8]

        def always(_):
            raise RuntimeError("down for good")

        with pytest.raises(RuntimeError, match="for good"):
            TF.watchdog_restart(always, d, max_restarts=1)


def test_heartbeat_stale_detection():
    with tempfile.TemporaryDirectory() as d:
        hb0 = TF.Heartbeat(d, 0)
        hb1 = TF.Heartbeat(d, 1)
        hb0.beat()
        hb1.beat()
        assert TF.Heartbeat.stale_hosts(d, timeout_s=5.0) == []
        time.sleep(0.05)
        hb0.beat()
        assert TF.Heartbeat.stale_hosts(d, timeout_s=0.04) == [1]


def test_sharding_doctests():
    import doctest

    result = doctest.testmod(TSS, verbose=False)
    assert result.failed == 0 and result.attempted > 0
