"""The port's sharded CA example (``repro_torch.examples.simplex_ca``)
on the CPU: the single-device demo, then the long sharded m=3 CA with a
simulated worker loss through the engine executor and through the SPMD
executor on 4 gloo ranks.  Each sharded run asserts its final state
bit-equal to an uninterrupted single-device engine run and exits
non-zero otherwise.
"""

import pytest

import port_threads  # noqa: F401  (one torch thread a worker)

from repro_torch.examples import simplex_ca

SHARDED = ["--devices", "4", "--device", "cpu", "--n3", "16", "--steps", "4",
           "--fail-at", "2", "--ckpt-every", "1"]


def test_single_device_demo(capfd):
    simplex_ca.main(["--device", "cpu", "--n", "32", "--steps", "2"])
    out = capfd.readouterr().out
    assert "2-simplex CA, n=32" in out and "gen 4: alive=" in out


@pytest.mark.parametrize("executor", ["engine", "spmd"])
def test_sharded_run_survives_a_worker_loss(executor, tmp_path, capfd):
    simplex_ca.main(SHARDED + ["--executor", executor, "--ckpt-dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert "[watchdog] resumed from checkpoint step 2" in out
    assert "watchdog restarts: 1" in out
    assert "sharded result bit-equals single-device engine: True" in out


def test_spmd_needs_a_card_a_rank_without_cpu():
    with pytest.raises(SystemExit, match="one card a rank"):
        simplex_ca.main(["--devices", "2", "--executor", "spmd"])
