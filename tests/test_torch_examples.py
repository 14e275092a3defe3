"""The port's examples (``repro_torch/examples/quickstart.py`` and
``serve_lm.py``) run on the CPU at their own sizes with every check
holding, and a failed check ends the run with a non-zero exit."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro_torch.examples import quickstart, serve_lm

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_TORCH_BENCH_ARTIFACT", str(tmp_path / "absent.json"))


def test_quickstart_runs_every_section(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "FAILED" not in out
    assert out.count(": ok") == 13
    for title in ("1. The block-space map H", "2. One scheduling API", "3. Any n",
                  "4. Kernels on the simplex (cpu)", "5. Causal attention"):
        assert title in out


def test_serve_lm_decodes(capsys):
    tokens = serve_lm.main(["--device", "cpu", "--gen", "8"])
    assert tokens.shape == (4, 9) and tokens.dtype == torch.long
    assert capsys.readouterr().out.count(": ok") == 2


def test_a_failed_check_exits_non_zero():
    with pytest.raises(quickstart.ExampleCheckFailed, match="the check"):
        quickstart.check(False, "the check")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", "from repro_torch.examples.quickstart "
                          "import check; check(False, 'seeded')"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "ExampleCheckFailed: seeded" in run.stderr
