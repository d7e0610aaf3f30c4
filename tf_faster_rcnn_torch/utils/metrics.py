"""Metrics writer: scalars as JSON lines, one line per write.

A copy of ``tf_faster_rcnn_tpu/utils/metrics.py``. The reference writes TF
summaries (network.py:437-450, train_val.py:148-151); the training loop
writes the same scalars here (step, wall time, prefix, values), greppable
and dependency-free, beside the TensorBoard events of ``utils/tb_writer.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

__all__ = ["MetricsWriter"]


class MetricsWriter(object):
    def __init__(self, out_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._f = open(self.path, "a", buffering=1)

    def write(self, step: int, values: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time(), "prefix": prefix}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
