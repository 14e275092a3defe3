"""The port's trace cost model (``roofline/trace_cost.py``) and the trace
half of ``roofline/analysis.py`` against the JAX package's HLO
counterparts (``repro/roofline/hlo_cost.py``, ``analysis.py``).

* ``wire_bytes`` equals the reference's for every collective kind and
  group size 1..16; ``roofline_terms`` equals the reference's to 1e-12
  with the reference's constants swapped in.
* FLOPs: the reference's two loop programs (``tests/test_substrate.py``:
  3 x 4 nested matmuls, and the gradient of 6 checkpointed steps) written
  as torch loops count what ``analyze_hlo`` counts on the compiled HLO.
* The census of a 4-rank gloo run of the mesh attention forward
  (rank program ``tests/port_trace.py``) has the one all-gather that
  ``collectives.exit_gather`` issues, its bytes from its shape.
* A CPU trace of a reduced yi-6b prefill gives host ops and FLOPs, and no
  device figure.
* The hand-written kernels' ops (flash forward, EDM) count by their
  registered formulas alone, on CPU and on ``meta`` tensors, their plain
  versions' own ops unseen.
"""

import json
import math
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

import port_threads  # noqa: F401  (one torch thread a worker)
import port_trace as P

from repro.roofline import analysis as RA
from repro.roofline.hlo_cost import analyze_hlo
from repro_torch.configs.ALL import REDUCED
from repro_torch.kernels import engine as TE
from repro_torch.kernels import flash_attention as TF
from repro_torch.models.model import Model
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import trace_cost as TC

SIDE = 128
SINGLE = 2 * SIDE**3
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all", "collective-permute",
         "send")


@pytest.fixture(autouse=True)
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_TORCH_BENCH_ARTIFACT", str(tmp_path / "absent.json"))


@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_equal_the_reference(kind):
    for g in range(1, 17):
        for operand, result in ((1024, 1024), (3000, 3000 * g), (7, 1)):
            assert TA.wire_bytes(kind, operand, result, g) == \
                RA.wire_bytes(kind, operand, result, g), (kind, g)


def test_roofline_terms_equal_the_reference_on_its_constants():
    rng = np.random.default_rng(0)
    for mode in ("train", "prefill", "decode"):
        for _ in range(4):
            rec = {"n_chips": int(rng.integers(1, 512)), "flops": float(rng.uniform(1e9, 1e18)),
                   "bytes_accessed": float(rng.uniform(1e6, 1e13)), "mode": mode,
                   "params": float(rng.uniform(1e6, 1e12)),
                   "params_active": float(rng.uniform(1e6, 1e11)),
                   "tokens": int(rng.integers(1, 1 << 20)),
                   "microbatches": int(rng.integers(1, 8)),
                   "model_axis": int(rng.choice([1, 2, 16])),
                   "collectives": {"wire_bytes_per_chip": float(rng.uniform(0, 1e12))}}
            mine = TA.roofline_terms(rec, peak_flops=RA.PEAK_FLOPS, hbm_bw=RA.HBM_BW,
                                     link_bw=RA.LINK_BW)
            want = RA.roofline_terms(rec)
            assert mine.keys() == want.keys()
            assert mine["dominant"] == want["dominant"]
            for k, v in want.items():
                if k != "dominant":
                    assert mine[k] == pytest.approx(v, rel=1e-12, abs=0), (mode, k)


def _ref_flops(fn, *shapes):
    sds = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*sds).compile().as_text())["flops"]


def test_nested_loop_flops_equal_analyze_hlo():
    def ref(x, w):
        def outer(c, _):
            c, _ = jax.lax.scan(lambda c2, _: (c2 @ w, None), c, None, length=4)
            return c, None

        return jax.lax.scan(outer, x, None, length=3)[0]

    def mine(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    g = torch.Generator().manual_seed(0)
    x, w = (torch.randn((SIDE, SIDE), generator=g) for _ in range(2))
    _, flops, _ = TC.flop_count(mine, x, w)
    assert sum(flops.values()) == _ref_flops(ref, (SIDE, SIDE), (SIDE, SIDE)) == 12 * SINGLE


def test_checkpointed_grad_flops_equal_analyze_hlo():
    def ref(w, x):
        def body(c, _):
            return jnp.tanh(c @ w), None

        return jnp.sum(jax.lax.scan(jax.checkpoint(body), x, None, length=6)[0])

    def mine(w, x):
        c = x
        for _ in range(6):
            c = checkpoint(lambda c: torch.tanh(c @ w), c, use_reentrant=False)
        return torch.autograd.grad(c.sum(), (w, x))

    g = torch.Generator().manual_seed(1)
    w = torch.randn((SIDE, SIDE), generator=g, requires_grad=True)
    # XLA's scan body takes the carry's gradient on every trip, the first
    # included; autograd takes it only where it is asked for, so the torch
    # loop asks for x's too (its last product, which XLA's first trip makes)
    x = torch.randn((SIDE, SIDE), generator=g, requires_grad=True)
    _, flops, _ = TC.flop_count(mine, w, x)
    want = _ref_flops(jax.grad(ref), (SIDE, SIDE), (SIDE, SIDE))
    assert sum(flops.values()) == want == 24 * SINGLE


def test_census_of_the_mesh_attention_forward(tmp_path):
    t0 = time.perf_counter()
    ranks = mp.start_processes(P.run_rank, args=(str(tmp_path / "store"), str(tmp_path)),
                               nprocs=P.WORLD, join=False, start_method="spawn")
    try:
        while not ranks.join(timeout=1):
            assert time.perf_counter() - t0 < 120, "the ranks did not finish"
    finally:
        for p in ranks.processes:
            if p.is_alive():
                p.kill()
    for r in range(P.WORLD):
        facts = json.loads(pathlib.Path(tmp_path / f"r{r}.json").read_text())
        want = facts["gathered_bytes"]
        assert facts["census"]["per_kind"] == {
            "all-gather": {"count": 1, "operand_bytes": want, "wire_bytes": float(want)}}
        assert facts["census"]["wire_bytes_per_chip"] == want


def test_cpu_trace_of_a_reduced_prefill_has_no_device_figures():
    cfg = REDUCED["yi-6b"]().replace(act_dtype="float32", param_dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s = 2, 32
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, flops, _ = TC.flop_count(model.prefill, {"tokens": tokens})
    out = TC.summarize(prof.events(), flops)
    assert out["kernels"] == {} and out["device"] is None
    assert "aten::mm" in out["host_ops"] or "aten::matmul" in out["host_ops"]
    assert out["collectives"] == {"per_kind": {}, "wire_bytes_per_chip": 0.0}
    # the flash forward by its formula, once a layer; every projection
    # 2 x rows x its weight's elements; the unembedding on the last token
    hd = cfg.d_model // cfg.n_heads
    attn = cfg.n_layers * 4 * b * cfg.n_heads * hd * s * (s + 1) // 2
    assert flops["repro_torch.flash_attention"] == attn
    proj = sum(p.numel() for n, p in model.named_parameters()
               if n.startswith("stack.") and p.ndim == 2 and "norm" not in n)
    unembed = cfg.d_model * cfg.vocab
    assert sum(v for k, v in flops.items() if k != "repro_torch.flash_attention") == \
        2 * b * s * proj + 2 * b * unembed
    assert out["flops_total"] == sum(flops.values())


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_ops_count_by_their_formulas(device):
    g = torch.Generator().manual_seed(3)
    b, hq, hkv, s, d = 2, 4, 2, 16, 8
    q = torch.randn(b, hq, s, d, generator=g).to(device)
    k, v = (torch.randn(b, hkv, s, d, generator=g).to(device) for _ in range(2))
    out, flops, moved = TC.flop_count(TF.flash_attention, q, k, v, block_q=4, block_kv=4,
                                      device=device)
    assert out.shape == q.shape and out.device.type == device
    assert flops == {"repro_torch.flash_attention": 4 * b * hq * d * s * (s + 1) // 2}
    assert moved == 2 * q.nbytes + k.nbytes + v.nbytes
    n, m, rho, dim = 16, 3, 2, 5
    p = torch.randn(n, dim, generator=g).to(device)
    field, flops, moved = TC.flop_count(TE.SimplexKernel("edm", m, rho=rho, kind="table",
                                                         device=device), p)
    assert field.shape == (n,) * m and field.device.type == device
    # one Gram product per point pair (3 at m = 3) of every valid tile
    tiles = int(TE.walk(TE.schedule_for(m, n // rho, "table"), "cpu")[1].sum())
    assert tiles == math.comb(n // rho + m - 1, m)
    assert flops == {"repro_torch.edm": tiles * 3 * 2 * rho * rho * dim}
    assert moved == p.nbytes + field.nbytes
