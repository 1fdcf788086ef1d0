"""Typed configuration parameter store with file persistence.
The port's own copy of ``lteax.stack.cnfg_db``.

(reference capability: ``LTE_fdd_enb_cnfg_db.{h,cc}`` — the typed parameter
store behind the ctrl socket's ``read``/``write`` commands, persisted to a
file and reloaded at start.)
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Callable


@dataclasses.dataclass
class Param:
    name: str
    value: Any
    typ: type
    lo: float | None = None
    hi: float | None = None
    choices: tuple | None = None


class CnfgDb:
    """Typed, range-checked parameters; atomic JSON persistence."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._params: dict[str, Param] = {}
        self._on_change: dict[str, Callable] = {}
        self._loaded: dict[str, Any] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self._loaded = json.load(f)

    def define(self, name: str, default, lo=None, hi=None, choices=None,
               on_change: Callable | None = None):
        value = self._loaded.get(name, default)
        p = Param(name, value, type(default), lo, hi,
                  tuple(choices) if choices else None)
        self._params[name] = p
        if on_change:
            self._on_change[name] = on_change
        return self

    def get(self, name: str):
        return self._params[name].value

    def set(self, name: str, value) -> None:
        p = self._params[name]
        if p.typ is bool and isinstance(value, str):
            value = value.lower() in ("1", "true", "on", "yes")
        else:
            value = p.typ(value)
        if p.lo is not None and value < p.lo:
            raise ValueError(f"{name} < {p.lo}")
        if p.hi is not None and value > p.hi:
            raise ValueError(f"{name} > {p.hi}")
        if p.choices is not None and value not in p.choices:
            raise ValueError(f"{name} not in {p.choices}")
        p.value = value
        self._save()
        cb = self._on_change.get(name)
        if cb:
            cb(value)

    def _save(self):
        if not self.path:
            return
        d = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump({n: p.value for n, p in self._params.items()}, f)
        os.replace(tmp, self.path)

    def as_ctrl_params(self) -> dict:
        """Live view dict for apps.ctrl.CtrlServer (read/write wiring)."""
        class _View(dict):
            def __init__(view):
                super().__init__({n: p.value for n, p in self._params.items()})

            def __getitem__(view, k):
                return self.get(k)

            def __setitem__(view, k, v):
                self.set(k, v)

            def __contains__(view, k):
                return k in self._params

        return _View()

    def items(self):
        return {n: p.value for n, p in self._params.items()}
