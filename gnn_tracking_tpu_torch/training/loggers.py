"""Experiment tracking: metric history and run metadata (counterpart of the
JAX ``training/loggers.py``).

* ``metrics.jsonl``: one JSON line an epoch with every metric;
* ``run_meta.json``: the config tree, the git commit, the environment
  (torch's version, the device's name, the number of devices);
* ``metrics.csv`` when asked for.

TensorBoard event files are written best-effort through
``torch.utils.tensorboard``; a ``log_hook`` callable fans the metrics out
to any other backend.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable

import torch

from gnn_tracking_tpu_torch.utils.versioning import get_commit_hash


def collect_run_metadata(config: dict | None = None, device: str | torch.device | None = None) -> dict[str, Any]:
    """Run metadata: the config, the git hash, argv, Python's and torch's
    versions, ``device`` (the card's name for a CUDA device, else
    ``"cpu"``; the current card by default where there is one), the number
    of devices of its kind, the time, and the SLURM / host variables that
    are set."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    cuda = device.type == "cuda"
    meta: dict[str, Any] = {
        "config": config or {},
        "git_hash": get_commit_hash(),
        "argv": sys.argv,
        "python": sys.version.split()[0],
        "torch_version": torch.__version__,
        "device": torch.cuda.get_device_name(device) if cuda else device.type,
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    for env in ("SLURM_JOB_ID", "SLURM_ARRAY_TASK_ID", "HOSTNAME"):
        if env in os.environ:
            meta[env.lower()] = os.environ[env]
    return meta


class RunLogger:
    """JSONL / CSV metric logger with TensorBoard events and a hook.

    ``tensorboard``: None (the default) writes scalars and the run metadata
    under ``<log_dir>/tb/`` where ``torch.utils.tensorboard`` imports (it
    needs the ``tensorboard`` package) and quietly writes none where it does
    not; True raises there; False writes none.
    """

    def __init__(
        self,
        log_dir: str | Path,
        *,
        config: dict | None = None,
        csv: bool = False,
        tensorboard: bool | None = None,
        log_hook: Callable[[int, dict[str, float]], None] | None = None,
        device: str | torch.device | None = None,
    ):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = self.log_dir / "metrics.jsonl"
        self._csv = self.log_dir / "metrics.csv" if csv else None
        self._csv_keys: list[str] | None = None
        self._hook = log_hook
        meta = collect_run_metadata(config, device)
        (self.log_dir / "run_meta.json").write_text(json.dumps(meta, indent=2, default=str))
        self._tb = None
        if tensorboard is not False:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.log_dir / "tb"))
                self._tb.add_text("run_meta", "```json\n" + json.dumps(meta, indent=2, default=str) + "\n```", 0)
            except Exception:  # noqa: BLE001 - TensorBoard is best-effort
                if tensorboard is True:
                    raise

    def log(self, step: int, metrics: dict[str, float]) -> None:
        """Append ``{"step": step, **metrics}`` (floats) to every output."""
        record = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        with self._jsonl.open("a") as f:
            f.write(json.dumps(record) + "\n")
        if self._csv is not None:
            if self._csv_keys is None:
                self._csv_keys = list(record)
                self._csv.write_text(",".join(self._csv_keys) + "\n")
            with self._csv.open("a") as f:
                f.write(",".join(str(record.get(k, "")) for k in self._csv_keys) + "\n")
        if self._tb is not None:
            for k, v in record.items():
                if k != "step" and not math.isnan(v):
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()
        if self._hook is not None:
            self._hook(step, metrics)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()

    def read_history(self) -> list[dict[str, float]]:
        if not self._jsonl.exists():
            return []
        return [json.loads(line) for line in self._jsonl.read_text().splitlines()]
