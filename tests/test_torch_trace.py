"""The port's tracing (``lteax_torch/utils/trace.py``, the torch.profiler
counterpart of ``lteax.utils.trace``): a ``profile_to`` directory holds a
Chrome trace with the ``stage`` ranges; the scanner's stages are ranges in
it as well as seconds in ``STAGE_SECONDS``; the bench CLIs' ``--trace``
writes one around the timed decodes; a decoder's stages nest as the
decode path runs them, in a recorder's spans and in a profiler's ranges,
and cost nothing when neither records; and ``TurboStats`` counts the
full-batch iterations and the host's wait at the syncs."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lteax_torch.apps import scanner
from lteax_torch.bench import dl_throughput
from lteax_torch.io.iq import write_iq
from lteax_torch.kernels import turbo_mlm
from lteax_torch.phy.channels import pusch
from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.pipeline import make_batch_decoder, make_pusch_batch_decoder
from lteax_torch.sim import ul_gen
from lteax_torch.sim.cell_gen import Cell, capture
from lteax_torch.sim.dl_gen import DlCell, dl_subframes
from lteax_torch.utils import trace

FRONT = {"dl": ["front.dft", "front.chest", "front.demap", "front.dematch"],
         "ul": ["front.chest", "front.dft", "front.demap", "front.dematch"]}


def _events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _names(path: str) -> set:
    return {e.get("name") for e in _events(path)}


def test_profile_to_writes_a_trace_with_the_stage(tmp_path):
    with trace.profile_to(str(tmp_path / "t")) as prof:
        with trace.stage("decode_batch"):
            torch.ones(64).cumsum(0)
        with trace.stage("other"):
            pass
    files = list((tmp_path / "t").iterdir())
    assert [str(f) for f in files] == [prof.trace_path]
    names = _names(prof.trace_path)
    assert {"lteax.decode_batch", "lteax.other", "aten::cumsum"} <= names
    with trace.stage("unprofiled"):     # a range with no profiler: no-op
        pass


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
    assert "lteax.scan" in _names(prof.trace_path)


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
    assert "lteax.decode_batch" in names
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


# -- a decoder's stages -----------------------------------------------------

@pytest.fixture(scope="module")
def decodes():
    """A small DL and a small UL decoder, each with a retry of one block
    over two subframes (the compacted retry's path), and their inputs."""
    dl = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=2)
    iq_dl, tb_dl = dl_subframes(dl, 2, snr_db=25.0, seed=3)
    ul = ul_gen.UlCell(alloc=pusch.PuschAlloc(n_prb=6, rb_start=0,
                                              mcs_tbs=1192, qm=4),
                       n_cell_id=301, subframe=2, rnti=0x5DEF)
    iq_ul, tb_ul = ul_gen.ul_subframes(ul, 2, snr_db=20.0, seed=5)
    return {
        "dl": (make_batch_decoder(*dl.decoder_args(), device="cpu",
                                  tuning=DecoderTuning(retry_m_dl=1)),
               torch.from_numpy(iq_dl), tb_dl),
        "ul": (make_pusch_batch_decoder(*ul.decoder_args(), device="cpu",
                                        tuning=DecoderTuning(retry_m=1)),
               torch.from_numpy(iq_ul), tb_ul)}


def _children(spans, parent: int) -> list:
    return [s.name for s in spans if s.parent == parent]


@pytest.mark.parametrize("link", ["dl", "ul"])
def test_a_decode_records_its_stages_nested(decodes, link):
    dec, iq, tb = decodes[link]
    with trace.recording() as rec:
        for _ in range(2):
            bits, ok, _ = dec(iq)
    assert ok.all() and np.array_equal(bits.numpy(), tb)
    spans = rec.spans()
    tops = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in tops] == ["decode", "decode"]
    for batch, top in enumerate(tops, start=1):
        mine = [s for s in spans if s.batch == batch]
        assert len(mine) == len(spans) // 2 and mine[0] is spans[top]
        assert _children(spans, top) == ["front", "turbo"]
        front = spans.index(next(s for s in mine if s.name == "front"))
        turbo = spans.index(next(s for s in mine if s.name == "turbo"))
        assert _children(spans, front) == FRONT[link]
        assert _children(spans, turbo) == ["turbo.layout", "turbo.iter",
                                           "turbo.compact", "turbo.crc"]
        for s in mine:
            assert s.end_ns >= s.start_ns and s.device_ms is None
            if s.parent is not None:
                p = spans[s.parent]
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_the_no_retry_path_is_the_early_stop_stage(decodes):
    _, iq, _ = decodes["dl"]
    one = make_batch_decoder(*DlCell(n_rb_dl=6, n_cell_id=150, mcs=9,
                                     cfi=2).decoder_args(), device="cpu")
    with trace.recording() as rec:
        one(iq)
    spans = rec.spans()
    turbo = [s.name for s in spans if s.name == "turbo"]
    assert turbo == ["turbo"] and one.last_stats.full == 0
    assert _children(spans, [s.name for s in spans].index("turbo")) == [
        "turbo.layout", "turbo.earlystop", "turbo.crc"]


def test_stages_cost_nothing_when_nothing_records(decodes, monkeypatch):
    """No profiler and no recorder: ``stage`` opens no range and keeps no
    span, and the outputs are bit for bit those of a recorded decode."""
    opened = []
    real = trace.record_function
    monkeypatch.setattr(trace, "record_function",
                        lambda name: opened.append(name) or real(name))
    for link in ("dl", "ul"):
        dec, iq, _ = decodes[link]
        off = dec(iq)
        assert opened == []
        with trace.recording() as rec:
            on = dec(iq)
        assert opened == [] and rec.spans()
        for a, b in zip(off[:2], on[:2]):
            assert torch.equal(a, b)
        assert off[2] == on[2]
    with trace.stage("unrecorded"):
        pass
    assert opened == []


def test_profile_to_nests_the_stages_under_decode(decodes, tmp_path):
    dec, iq, _ = decodes["dl"]
    with trace.profile_to(str(tmp_path)) as prof:
        dec(iq)
    ranges = {e["name"]: e for e in _events(prof.trace_path)
              if e.get("ph") == "X" and e["name"].startswith("lteax.")}
    assert set(ranges) == {"lteax.decode", "lteax.front", "lteax.turbo",
                           "lteax.turbo.layout", "lteax.turbo.iter",
                           "lteax.turbo.compact",
                           "lteax.turbo.crc",
                           *(f"lteax.{n}" for n in FRONT["dl"])}
    inside = lambda a, b: (b["ts"] <= a["ts"]
                           and a["ts"] + a["dur"] <= b["ts"] + b["dur"])
    for name, e in ranges.items():
        parent = name.rsplit(".", 1)[0]
        if name != "lteax.decode":
            assert inside(e, ranges[parent if parent != "lteax"
                                    else "lteax.decode"]), name


# -- the turbo decoder's counters -------------------------------------------

@pytest.mark.parametrize("case,full", [("clean", 1), ("one_fails", 1),
                                       ("all_fail", 2)])
def test_turbo_stats_count_full_iterations_and_waits(case, full,
                                                     monkeypatch):
    """On the retry path each full-batch iteration ends in one ``count``
    sync: ``full`` is their number, the early-stop loop's iterations add
    to ``n_iter``, and the syncs' wait is a host time."""
    k, c = 40, 6
    llr = torch.full((c, 3, k + 4), 4.0)      # the all-zero codeword
    gen = torch.Generator().manual_seed(7)
    noisy = {"clean": 0, "one_fails": 1, "all_fail": c}[case]
    llr[:noisy] = torch.randn((noisy, 3, k + 4), generator=gen) * 4.0
    counts = []
    real = turbo_mlm.TurboStats.count
    monkeypatch.setattr(turbo_mlm.TurboStats, "count",
                        lambda self, x: counts.append(1) or real(self, x))
    bits, stats = turbo_mlm.turbo_decode_batch(llr, k, n_iter=4,
                                               early_crc="24B", retry_m=2)
    assert stats.full == len(counts) == full <= stats.n_iter
    assert stats.wait_s >= 0 and stats.syncs >= len(counts)
    assert not bits[noisy:].any()
