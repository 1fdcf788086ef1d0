"""Checkpoint / resume for long scans (SURVEY.md §5).

(reference capability: the HSS user file + cnfg_db persistence are the
reference's only state files; for the batch framework the requirement
is idempotent per-capture-chunk work units so a restarted job re-processes
only unfinished chunks.)

State = JSON file mapping work-unit key -> result/status.  Writes are
atomic (tmp + rename) so a killed process never corrupts the state.

The port's own copy of ``lteax/utils/checkpoint.py``: the port
imports nothing of the JAX package, and ``tests/test_torch_plans.py``
holds the two equal.
"""

from __future__ import annotations

import json
import os
import tempfile


class ScanCheckpoint:
    def __init__(self, path: str):
        self.path = path
        self._state: dict[str, dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                self._state = json.load(f)

    def done(self, key: str) -> bool:
        return key in self._state

    def result(self, key: str) -> dict | None:
        return self._state.get(key)

    def record(self, key: str, result: dict) -> None:
        self._state[key] = result
        d = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self._state, f)
        os.replace(tmp, self.path)

    def pending(self, keys) -> list:
        return [k for k in keys if k not in self._state]
