"""The port's ``simplexlint`` (``repro_torch/analysis``).

* The port's tree gives no finding, through the registry and through
  ``python -m repro_torch.analysis.cli --json``.
* Each pass finds its seeded fault: a schedule whose map repeats a block
  (bijectivity and write-race), a shard mask that overlaps another
  (write-race), a stencil declaration off by one offset (halo), and
  modules under ``tmp_path`` that import ``jax``, fall back to a plain
  version in an ``except``, switch the device by an environment variable
  or cite a missing ``DESIGN.md`` section.
* Bijectivity and write-race give the reference's verdicts on the
  reference's matrix, label by label, and on the seeded schedule.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import port_threads  # noqa: F401  (one torch thread a worker)

from repro.analysis import schedule_passes as RSP
from repro_torch.analysis import run_passes
from repro_torch.analysis import schedule_passes as SP
from repro_torch.analysis.halo_passes import HALO_MN, check_body_halo
from repro_torch.core.schedule import SimplexSchedule
from repro_torch.distributed.simplex_sharding import shard_schedules
from repro_torch.kernels.engine import CABody

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_TORCH_BENCH_ARTIFACT", str(tmp_path / "absent.json"))


def test_the_tree_is_clean():
    assert run_passes(REPO) == []


def test_the_command_line_reports_json():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis.cli", "--json",
                          "--passes", "no-jax-import,design-xref"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    report = json.loads(run.stdout)
    assert report == {"version": 1, "passes": ["no-jax-import", "design-xref"],
                      "counts": {}, "findings": []}


class _Repeats:
    """A walk of T^2(4) whose last valid step repeats the first block."""

    kind = "repeats"
    m, n, prefetch = 2, 4, None

    def __init__(self):
        tab = SimplexSchedule(2, 4, "table").table()
        tab = tab[tab[:, -1] != 0].copy()
        tab[-1, :2] = tab[0, :2]
        self.tab = torch.from_numpy(tab.astype(np.int64))
        self.steps = len(tab)
        self.grid = (self.steps,)

    def map(self, lin):
        rows = self.tab[torch.as_tensor(np.asarray(lin))]
        return rows[..., 0], rows[..., 1], rows[..., 2] != 0


def test_a_repeated_block_is_found_by_both_schedule_passes():
    bad = _Repeats()
    bij = SP.check_schedule_bijectivity(bad, 2, 4)
    assert any("covered 2 times" in f.message for f in bij)
    assert any("never visited" in f.message for f in bij)
    race = SP.check_schedule_race(bad, 2, 4)
    assert len(race) == 1 and "write race" in race[0].message
    # the reference's checks see the same walk the same way
    assert bool(RSP.check_schedule_bijectivity(bad, 2, 4)) and bool(RSP.check_schedule_race(
        bad, 2, 4))


class _Overlapping:
    """A shard whose mask also claims another shard's blocks."""

    def __init__(self, shard, extra):
        self.shard, self.extra = shard, extra
        self.m, self.n, self.steps, self.grid = shard.m, shard.n, shard.steps, shard.grid
        self.prefetch, self.kind = shard.prefetch, shard.kind

    def map(self, *args):
        return self.shard.map(*args)

    def owned_block_mask(self):
        return self.shard.owned_block_mask() | self.extra


def test_an_overlapping_shard_mask_is_a_write_race():
    shards = shard_schedules(SimplexSchedule(3, 6, "table"), 3)
    assert SP.check_shard_masks(shards, 3, 6) == []
    bad = list(shards[:2]) + [_Overlapping(shards[2], shards[0].owned_block_mask())]
    found = SP.check_shard_masks(bad, 3, 6)
    assert any("overlaps shard 0" in f.message for f in found)
    assert any("outside" in f.message or "never writes" in f.message for f in found)


class _OffByOne(CABody):
    """CA whose declaration has (2, 1) where its update reads (1, 1)."""

    @staticmethod
    def stencil(m):
        return tuple((2,) + d[1:] if all(c == 1 for c in d) else d
                     for d in CABody.stencil(m))


class _Wraps(CABody):
    """CA that declares a wrapping boundary at every m."""

    @staticmethod
    def boundary(m):
        return "periodic"


@pytest.mark.parametrize("m,nb,kind", HALO_MN)
def test_the_ca_declaration_conforms_and_an_off_by_one_does_not(m, nb, kind):
    assert check_body_halo(CABody(), m, nb, kind) == []
    found = [f.message for f in check_body_halo(_OffByOne(), m, nb, kind)]
    assert any("undeclared read" in f and "(1, 1" in f for f in found), found
    assert any("stages 1 cell" in f for f in found), found
    if m > 2:
        found = [f.message for f in check_body_halo(_Wraps(), m, nb, kind)]
        assert any("not its periodic image" in f for f in found), found


BAD_MODULES = {
    "no-jax-import": "import numpy as np\nimport jax.numpy as jnp\n",
    "no-plain-fallback": ("def run(x):\n    try:\n        return FLASH.kernel(x)\n"
                          "    except RuntimeError:\n        return FLASH.plain(x)\n"),
    "no-env-device": ("import os\n\ndef device():\n"
                      "    return os.environ.get('REPRO_TORCH_DEVICE', 'cuda')\n"),
    # assembled here, so that the reference's design-xref pass, which reads
    # this file, does not take the seeded reference for one of its own
    "design-xref": '"""See DESIGN.md ' + '\u00a799."""\n',
}


@pytest.mark.parametrize("name", sorted(BAD_MODULES))
def test_each_ast_pass_finds_its_seeded_module(tmp_path, name):
    src = tmp_path / "src" / "repro_torch"
    src.mkdir(parents=True)
    (tmp_path / "DESIGN.md").write_text((REPO / "DESIGN.md").read_text())
    (src / "ok.py").write_text('"""DESIGN.md §7."""\nimport os\nimport torch\n'
                               "CACHE = os.environ.get('REPRO_TORCH_AUTOTUNE_CACHE')\n")
    assert run_passes(tmp_path, passes=[name]) == []
    (src / "bad.py").write_text(BAD_MODULES[name])
    found = run_passes(tmp_path, passes=[name])
    assert [(f.pass_name, f.path) for f in found] == [(name, "src/repro_torch/bad.py")]


def test_schedule_verdicts_equal_the_reference_on_its_matrix():
    assert SP.DEFAULT_MN == RSP.DEFAULT_MN and SP.SHARD_COUNTS == RSP.SHARD_COUNTS
    for check, rcheck in ((SP.check_schedule_bijectivity, RSP.check_schedule_bijectivity),
                          (SP.check_schedule_race, RSP.check_schedule_race)):
        mine = SP.run_matrix(check)
        ref = {(m, n, label): RSP._union_findings(rcheck, views, m, n)
               for m, ns in RSP.DEFAULT_MN.items() for n in ns
               for label, views in RSP.verified_schedules(m, n)}
        assert set(mine) == set(ref)
        assert {k: bool(v) for k, v in mine.items()} == {k: bool(v) for k, v in ref.items()}
