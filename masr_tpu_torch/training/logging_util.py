"""Scalar logging (copy of masr_tpu/training/logging_util.py): one JSON
line {tag, value, step, ts} per point in <log_dir>/scalars.jsonl."""
import json
import os
import time


class ScalarWriter(object):
    def __init__(self, log_dir="log"):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                       encoding="utf-8", buffering=1)

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")

    def close(self):
        self._f.close()
