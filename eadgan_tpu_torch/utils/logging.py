"""Structured per-step scalar logging.

Prints the reference-style progress lines (e.g. dSprites/rp.py:491-496)
*and* appends machine-readable JSONL records, replacing print-only
observability.

Device scalars are buffered and materialized in batches (every
``print_every`` steps and on close) — converting them eagerly would
force a device->host sync on every step, serializing the async dispatch
pipeline (a >2x slowdown on remote-execution runtimes).
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping, Optional

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None, print_every: int = 100):
        self.jsonl_path = jsonl_path
        self.print_every = print_every
        self._start = time.time()
        self._pending = []  # (step, t, {name: device_scalar})
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._fh = open(jsonl_path, "a")
        else:
            self._fh = None

    def _flush(self) -> None:
        if not self._fh:
            self._pending.clear()
            return
        for step, t, metrics in self._pending:
            record = {"step": step, "t": t}
            record.update({k: float(v) for k, v in metrics.items()})
            self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        self._pending.clear()

    def log(
        self,
        step: int,
        metrics: Mapping[str, float],
        *,
        epoch: Optional[int] = None,
        n_epochs: Optional[int] = None,
        batch: Optional[int] = None,
        n_batches: Optional[int] = None,
    ) -> None:
        should_print = step % self.print_every == 0
        if self._fh is None and not should_print:
            return
        if self._fh is not None:
            self._pending.append(
                (step, round(time.time() - self._start, 3), dict(metrics))
            )
            if should_print or len(self._pending) >= self.print_every:
                self._flush()
        if should_print:
            prefix = ""
            if epoch is not None and n_epochs is not None:
                prefix += f"[Epoch {epoch}/{n_epochs}] "
            if batch is not None and n_batches is not None:
                prefix += f"[Batch {batch}/{n_batches}] "
            body = " ".join(f"[{k}: {float(v):f}]" for k, v in metrics.items())
            print(prefix + body, flush=True)

    def close(self) -> None:
        self._flush()
        if self._fh:
            self._fh.close()
