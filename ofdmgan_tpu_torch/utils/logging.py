"""JSONL training metrics (counterpart of ``ofdmgan_tpu/utils/logging.py``;
TensorBoard is not ported)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, experiment: Optional[str] = None):
        experiment = experiment or time.strftime("%Y%m%d_%H%M%S")
        self.dir = Path(log_dir) / experiment
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a")

    def log_scalars(self, tag_prefix: str, scalars: Dict[str, Any], step: int):
        rec = {"step": step, "t": time.time()}
        rec.update({f"{tag_prefix}/{k}": float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
