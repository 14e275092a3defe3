"""Fault tolerance: heartbeats and the restart-from-checkpoint loop.

What a resumed run relies on:

1. **Checkpoint/restart** — atomic checkpoints
   (``checkpoint/checkpointing.py``: tmp dir + fsync + rename; the LATEST
   pointer checked against complete checkpoints) and a stateless data
   pipeline (``data/pipeline.py``: batch = f(seed, step)), so a resume is
   bit-exact.
2. **Node-failure handling** — ``watchdog_restart`` below: on a failure
   the run restarts from the latest complete checkpoint.  With
   ``torch.distributed`` the hook point on a real cluster is the group's
   store (``TCPStore`` or ``FileStore``), where ranks can publish and
   watch heartbeats; the file protocol of ``Heartbeat`` keeps the logic
   testable on one host.
3. **Multi-run consistency** — checkpoints carry their step, so a restart
   cannot apply a step twice.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

__all__ = ["watchdog_restart", "Heartbeat"]


class Heartbeat:
    """File-based heartbeat: each host writes its file every step, and
    the coordinator takes a stale file for a failed host."""

    def __init__(self, dir_: str, host: int):
        self.path = os.path.join(dir_, f"host_{host}.hb")
        os.makedirs(dir_, exist_ok=True)

    def beat(self):
        """Write the current time into this host's heartbeat file."""
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    @staticmethod
    def stale_hosts(dir_: str, timeout_s: float):
        """Host ids whose heartbeat is older than ``timeout_s`` seconds.

        Args:
            dir_: Heartbeat directory.
            timeout_s: Staleness threshold in seconds.

        Returns:
            Sorted list of failed host ids.
        """
        now = time.time()
        out = []
        for f in os.listdir(dir_):
            if f.endswith(".hb"):
                with open(os.path.join(dir_, f)) as fh:
                    t = float(fh.read() or 0)
                if now - t > timeout_s:
                    out.append(int(f.split("_")[1].split(".")[0]))
        return sorted(out)


def watchdog_restart(
    train_fn: Callable[[Optional[int]], None],
    ckpt_dir: str,
    max_restarts: int = 100,
) -> int:
    """Run ``train_fn(latest_step(ckpt_dir))``; on any exception, run it
    again from the latest complete checkpoint.

    Args:
        train_fn: The run; it takes the step to resume from (None for a
            fresh start).
        ckpt_dir: Where the run checkpoints.
        max_restarts: Restarts allowed before the failure propagates.

    Returns:
        How many restarts the run took.
    """
    from ..checkpoint.checkpointing import latest_step

    restarts = 0
    while True:
        try:
            start = latest_step(ckpt_dir)
            train_fn(start)
            return restarts
        except Exception:  # noqa: BLE001 — any failure triggers a restart
            restarts += 1
            if restarts > max_restarts:
                raise
