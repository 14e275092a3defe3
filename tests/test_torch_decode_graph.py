"""What lets the card capture the serving decode once and replay it
(``launch/graphs.StepGraph``): every family's reduced decode makes no
host read, no shape that depends on the data and no host tensor, and
``serve.run`` on the CPU, which decodes eagerly, gives the tokens of
``Model.decode`` called step by step.

A CUDA graph cannot hold a ``.item()`` (a host read waits for the card),
a data-dependent shape (``nonzero``) or a copy between the host and the
card.  On ``meta`` tensors each of those raises or cannot be made; on the
CPU a dispatch mode records them.  The replay itself runs only on the
card (``chip_smoke.py`` holds it against the eager decode there).
"""

import argparse

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import port_threads  # noqa: F401  (one torch thread a worker)

from repro_torch.configs.ALL import ARCH_IDS, REDUCED
from repro_torch.launch import serve
from repro_torch.launch.graphs import StepGraph
from repro_torch.models.model import Model

B, S = 2, 16
# Ops a captured step may not issue: a host read, a data-dependent shape, a
# tensor made from host data.  A copy to another device is checked apart.
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh")


def _model(arch: str, device: str) -> Model:
    cfg = REDUCED[arch]().replace(act_dtype="float32", param_dtype="float32")
    model = Model(cfg, device=device)
    if device == "cpu":
        model.init(torch.Generator().manual_seed(0))
    return model


def _step(device: str, tok: int = 3) -> dict:
    return {"tokens": torch.full((B, 1), tok, dtype=torch.long, device=device),
            "pos": torch.full((B,), S, dtype=torch.long, device=device)}


class _Record(TorchDispatchMode):
    """Every op the block dispatches, with its tensor arguments' devices
    and the device it was asked to put its result on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        devices = {a.device for a in args if isinstance(a, torch.Tensor)}
        self.ops.append((str(func.overloadpacket), devices, kwargs.get("device")))
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_runs_on_meta_tensors(arch):
    model = _model(arch, "meta")
    logits, new = model.decode(model.init_cache(B, S), _step("meta"))
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (B, 1, model.cfg.vocab)
    assert new["stack"] and len(new["stack"]) == model.cfg.n_periods


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_issues_nothing_a_graph_cannot_hold(arch):
    model = _model(arch, "cpu")
    caches = model.init_cache(B, S)
    with _Record() as rec:
        logits, _ = model.decode(caches, _step("cpu"))
    assert torch.isfinite(logits).all()
    bad = [op for op, _, _ in rec.ops if op in FORBIDDEN]
    assert not bad, f"{arch}: the decode issues {sorted(set(bad))}"
    moved = [(op, devs, to) for op, devs, to in rec.ops
             if to is not None and any(torch.device(to) != d for d in devs)]
    assert not moved, f"{arch}: the decode copies across devices: {moved[:3]}"
    assert len(rec.ops) > 100  # the mode saw the decode's ops


def _args(arch: str, gen: int) -> argparse.Namespace:
    return serve.parse_args(["--arch", arch, "--smoke", "--batch", str(B), "--prompt-len",
                             str(S), "--gen", str(gen), "--temperature", "0", "--device",
                             "cpu"])


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-moe-a2.7b", "qwen2-vl-72b",
                                  "seamless-m4t-large-v2"])
def test_cpu_serve_decodes_as_model_decode(arch):
    gen = 4
    r = serve.run(_args(arch, gen))
    assert r.capture_s is None and len(r.step_s) == gen
    assert r.decode_s == pytest.approx(sum(r.step_s))
    logits, caches = r.model.prefill(r.inputs)
    assert torch.equal(logits, r.prefill_logits)
    tok = logits[:, -1].argmax(-1)[:, None]
    want = [tok]
    for i in range(gen):
        step = {"tokens": tok, "pos": torch.full((B,), S + i, dtype=torch.long)}
        lg, _ = r.model.decode(caches, step)
        assert torch.equal(r.decode(step), lg)
        tok = lg[:, -1].argmax(-1)[:, None]
        want.append(tok)
    assert torch.equal(r.tokens, torch.cat(want, 1))


def test_step_graph_refuses_the_cpu():
    calls = []
    with pytest.raises(ValueError, match="CUDA"):
        StepGraph(lambda inp: calls.append(inp), _step("cpu"))
    assert not calls  # nothing ran eagerly instead


def test_step_graph_refuses_inputs_on_meta():
    with pytest.raises(ValueError, match="CUDA"):
        StepGraph(lambda inp: inp, _step("meta"))


def test_serve_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None serves on it")
    args = _args("yi-6b", 1)
    args.device = None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(args)
