"""Scalar/metric log writer — the VisualDL analog
(paddle_tpu/utils/log_writer.py, copied: the same JSON-lines records).

The reference streams training metrics to VisualDL through a hapi
callback (reference hapi/callbacks.py VisualDL writer; python/paddle
visualdl integration). Zero-egress equivalent: JSON-lines scalar logs
(one record per add_scalar) that any dashboard can tail, plus a reader
for tests/tools. Used by hapi via VisualDLCallback.
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["LogWriter", "read_scalars"]


class LogWriter:
    def __init__(self, logdir, filename="scalars.jsonl"):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, filename)
        self._f = open(self._path, "a", buffering=1)

    @property
    def path(self):
        return self._path

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({
            "tag": tag, "value": float(value), "step": int(step),
            "wall_time": time.time()}) + "\n")

    def add_scalars(self, main_tag, tag_value_dict, step):
        for k, v in tag_value_dict.items():
            self.add_scalar(f"{main_tag}/{k}", v, step)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_scalars(logdir, filename="scalars.jsonl", tag=None):
    path = os.path.join(logdir, filename)
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if tag is None or rec["tag"] == tag:
                out.append(rec)
    return out
