"""Step timing and the training run's metrics log (counterpart of
humannerf_tpu/utils/tracing.py).

  * `StepTimer`: steps per second over the steps since construction.
  * `ExperimentLogger`: the JSONL half of the JAX package's logger. Every
    `log` call appends one line `{<metric>: float, ..., "step": int}` to
    `<logdir>/metrics.jsonl`, flushed at once so the file tails cleanly.
    The JAX package also sends the line to wandb where that is installed
    and configured; the port has no wandb.
"""

from __future__ import annotations

import json
import os
import time


class StepTimer:
    """Steps per second over the steps since construction (host clock)."""

    def __init__(self):
        self.t0 = time.time()
        self.n = 0

    def tick(self, n: int = 1):
        self.n += n

    def rate(self) -> float:
        return self.n / max(time.time() - self.t0, 1e-9)


class ExperimentLogger:
    """Appends metric dictionaries to `<logdir>/metrics.jsonl`."""

    def __init__(self, logdir: str):
        self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def log(self, metrics: dict, step: int | None = None):
        payload = {k: float(v) for k, v in metrics.items()}
        if step is not None:
            payload["step"] = step
        self.jsonl.write(json.dumps(payload) + "\n")
        self.jsonl.flush()

    def finish(self):
        self.jsonl.close()
