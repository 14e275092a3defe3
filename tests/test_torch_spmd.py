"""The sharded CA's SPMD executor on 2 and 4 gloo ranks (CPU processes),
against the JAX package's CA oracle and the port's engine executor.

Each module fixture spawns one group (one torch thread a rank) that runs
every case of ``tests/port_spmd.py``; the ranks meet through a
``FileStore`` under the fixture's temporary directory, since several
test workers spawn groups at once.  Rank 0 saves the gathered results
and the errors ``shard_mesh``, ``shard_state`` and the runner raised.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch.multiprocessing as mp

import port_spmd
import port_threads  # noqa: F401  (one torch thread a worker)

from repro.kernels import ref as R
from repro_torch.distributed import simplex_sharding as TSS


def _spawn(tmp: pathlib.Path, k: int):
    mp.spawn(port_spmd.run_rank, args=(k, str(tmp / "store"), str(tmp)), nprocs=k, join=True)
    with open(tmp / f"k{k}.json") as f:
        facts = json.load(f)
    return dict(np.load(tmp / f"k{k}.npz")), facts


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("spmd2"), 2)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("spmd4"), 4)


# The JAX oracle, jitted: one compile a shape instead of one per operation.
CA = {2: jax.jit(R.ca2d_step), 3: jax.jit(R.ca_md_step)}


def _oracle(state, gens):
    for _ in range(gens):
        state = np.asarray(CA[state.ndim](state))
    return state


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("case", port_spmd.CASES, ids=[port_spmd.key(*c[:2], c[3])
                                                        for c in port_spmd.CASES])
def test_spmd_is_the_oracle_and_the_engine(k, case, ranks2, ranks4):
    m, n, kind, gens, seed = case
    results, facts = ranks2 if k == 2 else ranks4
    assert facts["world"] == k
    got = results[port_spmd.key(m, n, gens)]
    start = port_spmd.state(m, n, seed)
    assert np.array_equal(got, _oracle(start, gens))
    engine = TSS.sharded_ca(start, k, steps=gens, kind=kind, devices=["cpu"])
    assert np.array_equal(got, engine.numpy())


@pytest.mark.parametrize("k", [2, 4])
def test_spmd_helpers_raise(k, ranks2, ranks4):
    errors = (ranks2 if k == 2 else ranks4)[1]["errors"]
    assert f"need {k + 1} ranks, found a group of {k}" in errors["mesh_size"]
    assert "nccl" in errors["mesh_backend"]  # CUDA tensors never fall back to gloo
    assert "must divide" in errors["state_divides"]
    assert "not k=" in errors["runner_k"]
