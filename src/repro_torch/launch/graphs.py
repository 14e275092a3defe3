"""A step captured once as a CUDA graph and replayed.

The port's counterpart of the reference's ``jax.jit`` over a serving step
whose shapes never change (``launch/serve.py``'s decode, the compiled
``serve_step`` of ``launch/steps.py``).  ``StepGraph`` runs the step
twice on the side stream it captures on (one a device for every graph of
the process), so that cuBLAS handles and workspaces and every lazy
initialisation happen outside the capture, then captures one call into a
``torch.cuda.CUDAGraph`` with a memory pool of its own.  The capture mode
is ``"thread_local"``: only the capturing thread's calls may break it,
since NCCL's watchdog thread queries the runtime while a step of
``StepBundle`` is captured.  Unlike ``torch.cuda.graph``, it does not
empty the allocator's cache before the capture: after a prefill that
frees the prefill's cached blocks, the most variable part of a capture's
time (``scripts/decode_capture_costs.py`` measures it), and the graph's
pool allocates blocks of its own either way.  Each later call copies its inputs into
the graph's static input buffers and replays the graph: one launch on
the host for every kernel the eager step launched, on the same
addresses, so the outputs equal the eager step's.

What a captured step may not do: copy between the host and the card, read
a value on the host (``.item()``), or make a tensor whose shape depends on
the data.  ``tests/test_torch_decode_graph.py`` holds every family's
decode to that on the CPU and on ``meta`` tensors.

Python runs only while the step is warmed up and captured: a launch
counter or a record that the step appends to counts those calls, never a
replay.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import torch

__all__ = ["StepGraph", "WARMUP"]

# Eager calls of a step on the side stream before its capture.
WARMUP = 2
# The side stream of every capture on a device: cuBLAS keeps a workspace
# (32 MiB on an H100) for each stream it has run on, for the process's life.
_STREAMS: Dict[torch.device, Any] = {}


class StepGraph:
    """``fn(inputs)`` captured once on the card, replayed by each call.

    Args:
        fn: The step, a function of ``{name: tensor}``.  Whatever else it
            reads (weights, caches) is bound at capture: it must stay
            alive and in place while the graph is used.
        inputs: Example inputs, CUDA tensors on one device.  Their shapes,
            dtypes and strides are fixed; their values are copied into the
            static buffers.

    Attributes:
        inputs: The static input buffers, ``{name: tensor}``.
        outputs: What the captured call of ``fn`` returned.  Its tensors
            are static buffers in the graph's pool: the next replay
            overwrites them, so a caller clones whatever it keeps past it.
        capture_s: Seconds of warm-up and capture, synchronised.

    Raises:
        ValueError: an input is not a CUDA tensor, or the inputs lie on
            more than one device.  A step on the CPU is the caller's to
            run eagerly.
        RuntimeError: the capture failed, as ``CUDAGraph.capture_end``
            raises it; nothing runs the step eagerly instead.
    """

    def __init__(self, fn: Callable[[Dict[str, torch.Tensor]], Any],
                 inputs: Dict[str, torch.Tensor]):
        devices = {t.device for t in inputs.values()}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"StepGraph captures CUDA work only; the inputs lie on "
                             f"{sorted(map(str, devices))}")
        device = devices.pop()
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            self.inputs = {k: v.clone() for k, v in inputs.items()}
            if device not in _STREAMS:
                _STREAMS[device] = torch.cuda.Stream(device)
            side = _STREAMS[device]
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(self.inputs)
                torch.cuda.synchronize(device)
                self.graph = torch.cuda.CUDAGraph()
                self.graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                         capture_error_mode="thread_local")
                try:
                    self.outputs = fn(self.inputs)
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, inputs: Dict[str, torch.Tensor]) -> Any:
        """Copy ``inputs`` (the captured names, any device) into the static
        buffers and replay; returns ``outputs``."""
        if inputs.keys() != self.inputs.keys():
            raise KeyError(f"StepGraph was captured on inputs {sorted(self.inputs)}, "
                           f"given {sorted(inputs)}")
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        return self.outputs

    def pool_bytes(self) -> int:
        """Bytes the graph's private pool holds on the card (its segments,
        what the capture allocated and kept)."""
        pool = tuple(self.graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)
