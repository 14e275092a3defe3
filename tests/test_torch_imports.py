"""The port stands alone: nothing under src/repro_torch/, and not
chip_smoke.py, imports JAX or the JAX package ``repro``."""

import ast
import pathlib
import subprocess
import sys

import pytest
import port_threads  # noqa: F401  (one torch thread a worker)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == root or name.startswith(root + ".") for root in ("jax", "repro"))


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_port_has_modules():
    names = {p.relative_to(REPO / "src").as_posix() for p in PORT_FILES[:-1]}
    for want in ("repro_torch/core/schedule.py", "repro_torch/kernels/engine.py",
                 "repro_torch/kernels/ops.py", "repro_torch/kernels/policy.py",
                 "repro_torch/kernels/ref.py", "repro_torch/kernels/_build.py",
                 "repro_torch/state.py", "repro_torch/kernels/flash_attention.py",
                 "repro_torch/configs/base.py", "repro_torch/configs/yi_6b.py",
                 "repro_torch/configs/ALL.py", "repro_torch/models/layers.py",
                 "repro_torch/models/attention.py", "repro_torch/models/transformer.py",
                 "repro_torch/models/model.py", "repro_torch/models/convert.py",
                 "repro_torch/autotune/tuner.py", "repro_torch/launch/serve.py",
                 "repro_torch/kernels/legacy.py", "repro_torch/kernels/simplex_kernels.py",
                 "repro_torch/kernels/hmap_mxu.py", "repro_torch/configs/granite_8b.py",
                 "repro_torch/configs/internlm2_20b.py", "repro_torch/configs/stablelm_12b.py",
                 "repro_torch/optim/optimizer.py", "repro_torch/data/pipeline.py",
                 "repro_torch/checkpoint/checkpointing.py", "repro_torch/launch/train.py",
                 "repro_torch/examples/train_lm.py", "repro_torch/models/moe.py",
                 "repro_torch/models/mla.py", "repro_torch/models/mamba.py",
                 "repro_torch/configs/qwen2_moe_a27b.py",
                 "repro_torch/configs/deepseek_v3_671b.py",
                 "repro_torch/configs/jamba_v01_52b.py", "repro_torch/models/xlstm.py",
                 "repro_torch/configs/xlstm_350m.py", "repro_torch/configs/qwen2_vl_72b.py",
                 "repro_torch/configs/seamless_m4t_large_v2.py",
                 "repro_torch/distributed/simplex_sharding.py",
                 "repro_torch/distributed/fault_tolerance.py",
                 "repro_torch/examples/simplex_ca.py",
                 "repro_torch/distributed/sharding.py",
                 "repro_torch/distributed/compression.py",
                 "repro_torch/distributed/collectives.py", "repro_torch/launch/mesh.py",
                 "repro_torch/launch/steps.py", "repro_torch/analysis/__init__.py",
                 "repro_torch/analysis/registry.py", "repro_torch/analysis/ast_passes.py",
                 "repro_torch/analysis/schedule_passes.py",
                 "repro_torch/analysis/halo_passes.py", "repro_torch/analysis/cli.py",
                 "repro_torch/roofline/trace_cost.py", "repro_torch/launch/dryrun.py",
                 "repro_torch/examples/quickstart.py", "repro_torch/examples/serve_lm.py"):
        assert want in names
    for cu in ("map.cu", "accum.cu", "edm.cu", "ca.cu", "simplex_maps.cuh",
               "flash_attention.cu", "legacy2d.cu", "legacy_md.cu", "hmap_mxu.cu",
               "mma_tf32.cuh", "flash_wgmma.cu", "flash_common.cuh", "dtypes.cuh"):
        assert (REPO / "src/repro_torch/kernels/csrc" / cu).is_file()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_repro_import(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import sys; import repro_torch.kernels.ops, repro_torch.kernels.engine, "
        "repro_torch.state, repro_torch.core, repro_torch.launch.serve, "
        "repro_torch.models.convert, repro_torch.models.moe, repro_torch.models.mla, "
        "repro_torch.models.mamba, repro_torch.models.xlstm, repro_torch.kernels.legacy, "
        "repro_torch.kernels.simplex_kernels, repro_torch.kernels.hmap_mxu, "
        "repro_torch.optim.optimizer, repro_torch.data.pipeline, "
        "repro_torch.checkpoint.checkpointing, repro_torch.launch.train, "
        "repro_torch.examples.train_lm, repro_torch.distributed, "
        "repro_torch.distributed.fault_tolerance, repro_torch.examples.simplex_ca, "
        "repro_torch.distributed.sharding, repro_torch.distributed.compression, "
        "repro_torch.distributed.collectives, repro_torch.launch.mesh, "
        "repro_torch.launch.steps, repro_torch.analysis, repro_torch.analysis.cli, "
        "repro_torch.roofline.trace_cost, repro_torch.launch.dryrun, "
        "repro_torch.examples.quickstart, repro_torch.examples.serve_lm; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
        "assert not bad, bad"
    )
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
