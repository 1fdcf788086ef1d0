"""The harness on the CPU: ``BENCHMARK.json`` keeps to the benchmark's
contract, every piece loads by its name, a dry run at a tiny batch prints
a result line of the contract's shape, a run with no card fails, nothing
the benchmark runs imports JAX or the JAX package, and the control and
each planted fault turn ``correct`` false.  The cells themselves run on
the card only (``cuda``)."""

import ast
import contextlib
import json
import re
import subprocess
import sys

import pytest
import torch

from benchmark import check, faults, readings, run, spec

ROOT = spec.ROOT
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["reduced"] == []
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert spec.config(c["name"])["source"] == c["source"]
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert {w["config"] for w in BENCH["workloads"]} == names
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"decoded_mbit_s", "batch_p95_ms", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["moves"] in e2e - {"setup_s"} and m["source"] in SOURCES
        assert _line(m["layer"])
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    every = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(every) == len(set(every))
    assert len(BENCH["per_layer"]) >= 1 and len(layers) >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_loads_by_name(cell):
    w = spec.workload(BENCH, cell)
    cfg = spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    limits = spec.limits(cell)
    assert set(limits) == {"llr_sign_gap", "tb_lost", "crc_false_pass"}
    assert limits["crc_false_pass"] == 0
    assert traffic["batch"] % traffic["distinct_tbs"] == 0
    system = spec.system(cfg)
    assert system.geometry(cfg).c == 13 and system.geometry(cfg).k == 5824
    for trace in (False, True):
        for m in spec.metrics(BENCH, cell, trace):
            assert callable(spec.reader(m["name"]))


def _dry_run(cell: str, trace: int, *extra: str):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "1", "--trace", str(trace), *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_dry_run_prints_the_result_line(trace):
    cell = "dl20_mcs28.clean"
    out = _dry_run(cell, trace, "--cpu-dry-run")
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] > 0
    assert result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    assert result["device"]["kind"] == "cpu"
    names = {m["name"] for m in spec.metrics(BENCH, cell, bool(trace))}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
    else:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    tail = out.stderr.strip().splitlines()[-len(result["checks"]):]
    assert all(ln.startswith("check ") for ln in tail)


def test_a_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _dry_run("dl20_mcs28.clean", 0)
    assert out.returncode != 0 and not out.stdout.strip()


FORBIDDEN = run.FORBIDDEN | {"bench"}
YARDSTICK = ("lte", "tx", "reference", "counts", "check", "devtrace",
             "traffic", "spec", "window")


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for name in YARDSTICK:
        assert "lteax_torch" not in _imports(ROOT / "benchmark" /
                                             f"{name}.py"), name


def _judged(cell: str, decoder_tuning: dict | None = None,
            fault: str | None = None) -> dict:
    """One reading of ``benchmark/readings.py`` at the dry run's sizes,
    judged against the cell's limits."""
    w = spec.workload(BENCH, cell)
    cfg = spec.config(w["config"])
    traffic = {**spec.traffic(w["traffic"]), **run.DRY_RUN}
    system = spec.system(cfg)
    dec = system.decoder(cfg, {**cfg["tuning"], **(decoder_tuning or {})},
                         torch.device("cpu"))
    with (faults.planted(fault, dec, system.geometry(cfg).c) if fault
          else contextlib.nullcontext()):
        numbers = readings.reading(system, cfg, traffic, dec, 2147483661,
                                   0.1, torch.device("cpu"))
    return check.judged(numbers, spec.limits(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The program with its int8 LLR path switched on: the sign gap of its
    front's LLRs is over the limit."""
    checks = _judged(cell, {"planar_int8": True})
    assert not check.correct(checks)
    assert checks["llr_sign_gap"]["value"] > checks["llr_sign_gap"]["limit"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_planted_fault_is_not_correct(fault):
    assert not check.correct(_judged("dl20_mcs28.clean", fault=fault))


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_planted_fault_is_not_correct_at_the_ul_edge(fault):
    """The UL tail at its threshold SNR, where it iterates up to 6
    times."""
    assert not check.correct(_judged("ul20_64qam.edge", fault=fault))


def test_the_sweep_counts_crc_failures(capsys):
    """``benchmark/sweep.py`` at the dry run's sizes: one line a seed and
    SNR; far below the UL threshold blocks fail, at 25 dB none does."""
    from benchmark import sweep
    assert sweep.main(["--config", "ul20_64qam", "--traffic",
                       "closed_b1024_snr25", "--snrs", "14,25", "--seeds",
                       "2147483663", "--cpu-dry-run"]) == 0
    low, high = (json.loads(ln) for ln in
                 capsys.readouterr().out.strip().splitlines())
    assert low["blocks"] == high["blocks"] == 2 * run.DRY_RUN["batch"]
    assert low["crc_failed"] > 0 and low["turbo_iters"] == 6
    assert high["crc_failed"] == 0 and high["bler"] == 0
    assert low["crc_false_pass"] == high["crc_false_pass"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _dry_run(cell, 0)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
