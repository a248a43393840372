"""Structured run metrics (port of `rnn_transducer_tpu/utils/logging.py`'s
MetricsLogger): one JSON record a line, appended to a file, with the
seconds since the logger started as `wall_s`, and mirrored to stderr."""

from __future__ import annotations

import json
import sys
import time


class MetricsLogger:
    """Append-only JSONL metrics log (plus mirrored stderr lines)."""

    def __init__(self, path: str | None = None, mirror: bool = True):
        self.path = path
        self.mirror = mirror
        self._f = open(path, "a") if path else None
        self.t0 = time.time()

    def log(self, **record):
        record.setdefault("wall_s", round(time.time() - self.t0, 3))
        line = json.dumps(record)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.mirror:
            print(line, file=sys.stderr, flush=True)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
