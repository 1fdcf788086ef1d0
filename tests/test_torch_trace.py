"""The port's tracing helpers (``lteax_torch/utils/trace.py``, the
torch.profiler counterpart of ``lteax.utils.trace``): a ``profile_to``
directory holds a Chrome trace with the ``stage`` ranges; the scanner's
stages are ranges in it as well as seconds in ``STAGE_SECONDS``; the
bench CLIs' ``--trace`` writes one around the timed decodes; and
``wall_timer`` accumulates as the reference's does."""

import json
from pathlib import Path

import torch

from lteax.utils import trace as trace_ref

from lteax_torch.apps import scanner
from lteax_torch.bench import dl_throughput
from lteax_torch.io.iq import write_iq
from lteax_torch.sim.cell_gen import Cell, capture
from lteax_torch.utils import trace


def _names(path: str) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profile_to_writes_a_trace_with_the_stage(tmp_path):
    with trace.profile_to(str(tmp_path / "t")) as prof:
        with trace.stage("decode_batch"):
            torch.ones(64).cumsum(0)
        with trace.stage("other"):
            pass
    files = list((tmp_path / "t").iterdir())
    assert [str(f) for f in files] == [prof.trace_path]
    names = _names(prof.trace_path)
    assert {"decode_batch", "other", "aten::cumsum"} <= names
    with trace.stage("unprofiled"):     # a range with no profiler: no-op
        pass


def test_wall_timer_as_the_reference():
    for mod in (trace, trace_ref):
        rec = {}
        for _ in range(2):
            with mod.wall_timer(rec, "k"):
                pass
        assert list(rec) == ["k"] and 0 <= rec["k"] < 1.0


def test_scanner_stages_are_ranges(tmp_path):
    cap = capture(Cell(n_rb_dl=6, n_cell_id=21), 0.012, offset=100,
                  device="cpu")
    path = str(tmp_path / "c.fc32")
    write_iq(path, cap.iq)
    before = scanner.STAGE_SECONDS["scan"]
    with trace.profile_to(str(tmp_path / "t")) as prof:
        rep = scanner.scan_channels([scanner.Channel("c", path)],
                                    scanner.PhyConfig(n_rb_dl=6),
                                    device="cpu")
    assert rep[0]["n_cell_id"] == 21
    assert scanner.STAGE_SECONDS["scan"] > before
    assert "scan" in _names(prof.trace_path)


def test_bench_cli_trace(tmp_path, capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = dl_throughput.main(["--batch", "2", "--reps", "1", "--iq",
                                  "bf16", "--trace", str(tmp_path),
                                  "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert out["crc_ok"] == 2 and out["iq"] == "bf16"
    assert "bf16 IQ in" in out["metric"]
    assert Path(out["trace"]).parent == tmp_path
    names = _names(out["trace"])
    assert "decode_batch" in names
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
