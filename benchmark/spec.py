"""Everything the harness finds by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``benchmark/`` a configuration
(``configs/<name>.json``, its system in ``systems/<system>.py``), a traffic
mix (``traffic/<name>.json``), a cell's limits (``limits/<cell>.json``)
and a metric's reader (``metrics/<name>.py``, a ``read(run)`` that returns
the value or None where it finds nothing to read).  Adding one of these
is adding a file and an entry in ``BENCHMARK.json``.  What a system
module gives the harness, and the shapes of a row that carries more than
one transport block (``codewords``), are in ``benchmark/systems``."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{_checked(name)}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{_checked(name)}.json")


def limits(cell: str) -> dict:
    return _json(HERE / "limits" / f"{_checked(cell)}.json")


def system(cfg: dict):
    return importlib.import_module(
        f"benchmark.systems.{_checked(cfg['system'])}")


def codewords(system) -> int:
    """The transport blocks a subframe row of ``system`` carries."""
    return getattr(system, "codewords", 1)


def reader(metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{_checked(metric)}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` False) or its per-layer
    ones: every entry without ``workloads`` and those that list it."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Run:
    """What the readers read: the cell, the window's record, the set-up
    time and, in a traced run, the trace's summary."""
    cfg: dict
    traffic: dict
    system: object
    record: object
    setup_s: float
    trace: dict | None = None
