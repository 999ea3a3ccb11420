"""Append-only JSONL scalar log (counterpart of
``dynaboa_tpu/metrics/writer.py``, which cannot be imported without jax):
one JSON object per step under the reference's key names (ll/*, ul/*,
teacher/*, feat_sim/*, metrics/*), flushed at most every ``flush_secs``."""

from __future__ import annotations

import json
import os
import time


class ScalarWriter:
    def __init__(self, logdir: str, filename: str = "scalars.jsonl",
                 flush_secs: float = 5.0):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._f = open(self.path, "a")
        self._t0 = time.time()
        self._flush_secs = flush_secs
        self._last_flush = self._t0

    def write(self, step: int, scalars: dict) -> None:
        now = time.time()
        rec = {"step": int(step), "t": round(now - self._t0, 4)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(rec) + "\n")
        if now - self._last_flush >= self._flush_secs:
            self.flush()

    def flush(self) -> None:
        self._f.flush()
        self._last_flush = time.time()

    def close(self) -> None:
        self._f.close()
