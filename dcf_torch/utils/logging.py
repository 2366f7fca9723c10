"""Training metrics log: one line per call to stdout and, when a path is
given, one JSON object per line to a JSONL file (the counterpart of
`dcf.utils.logging.MetricsLogger`, without the TensorBoard mirror)."""

from __future__ import annotations

import json
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None):
        self.jsonl_path = jsonl_path

    def log(self, metrics: Dict[str, float]) -> None:
        line = " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(metrics.items()))
        print(f"[train] {line}", flush=True)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(metrics) + "\n")
