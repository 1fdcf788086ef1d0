"""The reduction of a host-and-device trace by the program's ``lteax.*``
ranges (``benchmark/spans.py``), on a hand-written trace whose every
number is known, and the traced CPU dry run's counters."""

import json

import pytest

from benchmark import spans
from benchmark.tests.test_benchmark_harness import _dry_run

LOOP, OTHER = 1, 2


def _x(name, cat, ts, dur, tid=LOOP, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def _trace():
    """One batch, 100-200 us: ``lteax.turbo`` holds ``lteax.turbo.iter``
    (100-165).  The turbo kernel (launched at 100 in iter) runs 100-150, a
    copy (launched at 140 in iter) 150-160, a gather (launched at 166 in
    turbo) 170-200; the device idles 160-170, the host in iter until 165
    and in turbo after it."""
    return {"traceEvents": [
        _x("benchmark.batch", "user_annotation", 100, 100),
        _x("lteax.turbo", "user_annotation", 100, 100),
        _x("lteax.turbo.iter", "user_annotation", 100, 65),
        _x("lteax.turbo", "user_annotation", 0, 500, tid=OTHER),
        _x("lteax.turbo", "gpu_user_annotation", 100, 100, tid=7),
        _x("cudaLaunchKernel", "cuda_runtime", 100, 2, correlation=1),
        _x("cudaMemcpyAsync", "cuda_runtime", 140, 2, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 166, 2, correlation=3),
        _x("void turbo_half_bf16_kernel<true>(float*)", "kernel", 100, 50,
           tid=7, correlation=1),
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 150, 10, tid=7,
           correlation=2),
        _x("void at::native::index_elementwise_kernel<128, 4>(int)",
           "kernel", 170, 30, tid=7, correlation=3),
        {"ph": "s", "name": "ac2g", "ts": 100, "id": 1, "pid": 0, "tid": 1},
    ]}


def test_reduce_attributes_a_hand_written_trace_exactly(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_trace()))
    out = spans.reduce(str(path))
    assert out["batches"] == 1
    assert out["window_s"] == pytest.approx(100e-6)
    assert set(out["by_span"]) == {"lteax.turbo", "lteax.turbo.iter"}
    it, turbo = out["by_span"]["lteax.turbo.iter"], out["by_span"][
        "lteax.turbo"]
    assert it["kernels"] == 1 and turbo["kernels"] == 1
    assert it["device_s"] == pytest.approx(60e-6)
    assert turbo["device_s"] == pytest.approx(30e-6)
    assert it["idle_s"] == pytest.approx(5e-6)
    assert turbo["idle_s"] == pytest.approx(5e-6)
    assert out["turbo_glue_s"] == pytest.approx(40e-6)


def test_a_trace_with_no_batch_reads_nothing(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": []}))
    assert spans.reduce(str(path))["batches"] == 0


@pytest.mark.parametrize("cell", ["dl20_mcs28.clean", "ul20_64qam.clean"])
def test_the_traced_dry_run_reports_the_counters(cell):
    out = _dry_run(cell, 1, "--cpu-dry-run")
    assert out.returncode == 0, out.stderr[-2000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])["metrics"]
    assert metrics["full_iters"]["value"] >= 1
    assert metrics["full_iters"]["value"] <= metrics["turbo_iters"]["value"]
    assert metrics["sync_wait_ms"]["value"] > 0
    logged = [json.loads(ln)["spans"] for ln in out.stderr.splitlines()
              if ln.startswith('{"spans"')]
    assert len(logged) == 1 and len(logged[0]["full"]) == 2
