"""The port's multi-process entry points on the CPU: the multi-host scanner
(``python -m lteax_torch.apps.scanner --multihost 2``, gloo over TCP on
127.0.0.1, two workers on ``--device cpu``), the multi-rank dry run
(``shard.dryrun.dryrun_multichip``), the scaling CLI
(``lteax_torch.bench.scaling``) and the multi-process dry run
(``lteax_torch.bench.multihost_dryrun``).

The scanner's workers each scan the channels ``ci % 2`` of four 6-PRB
captures (three cells, one of noise) with ``--prescan`` and per-worker
checkpoints: each worker's reports equal the one-process scan's, both
print the summed count of decoded cells, and that count equals the cells
whose MIB the reference's capture scan decodes
(``lteax.apps.file_scan.scan(x, cfg, max_si_subframes=0)``); a relaunch
after a worker lost one channel's checkpoint re-scans that channel only
(the others' captures are gone by then), and a worker that fails fails
the job with the reference's message."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lteax.apps.file_scan import scan as scan_ref
from lteax.io.iq import read_iq as read_iq_ref
from lteax.phy.config import PhyConfig as RefPhyConfig

from lteax_torch.apps import scanner
from lteax_torch.bench import multihost_dryrun, scaling
from lteax_torch.io.iq import write_iq
from lteax_torch.phy.config import PhyConfig
from lteax_torch.shard.dryrun import dryrun_multichip
from lteax_torch.sim import cell_gen

REPO = Path(__file__).resolve().parents[1]
CFG = PhyConfig(n_rb_dl=6)
CELLS = {0: 50, 2: 52, 3: 53}          # channel -> cell id; channel 1: noise


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(0)
    specs = []
    for i in range(4):
        if i in CELLS:
            x = cell_gen.generate(cell_gen.Cell(n_rb_dl=6,
                                                n_cell_id=CELLS[i]), 20,
                                  device="cpu")
        else:
            x = (0.01 * (rng.standard_normal(30720)
                         + 1j * rng.standard_normal(30720))
                 ).astype(np.complex64)
        write_iq(str(d / f"ch{i}.fc32"), x)
        specs.append(f"ch{i}={d / f'ch{i}.fc32'}")
    return d, specs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _multihost(specs, *extra):
    """The coordinator as a user starts it: (return code, stdout lines as
    JSON objects)."""
    res = subprocess.run(
        [sys.executable, "-m", "lteax_torch.apps.scanner", *specs,
         "--multihost", "2", "--device", "cpu", "--port", str(_free_port()),
         *extra],
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    return res.returncode, [json.loads(ln) for ln in res.stdout.splitlines()
                            if ln.startswith("{")], res.stderr


@pytest.fixture(scope="module")
def first_run(captures):
    d, specs = captures
    ckpt = str(d / "scan.ckpt")
    rc, lines, err = _multihost(specs, "--prescan", "--checkpoint", ckpt)
    assert rc == 0, err
    return ckpt, lines


def _reports(lines):
    return {d["channel"]: d for d in lines if "channel" in d}


def test_workers_own_their_channels_and_match_one_process(captures,
                                                          first_run):
    _, specs = captures
    _, lines = first_run
    reps = _reports(lines)
    assert {c: d["worker"] for c, d in reps.items()} == \
        {f"ch{i}": i % 2 for i in range(4)}
    chans = scanner._parse_channels(specs)
    one = scanner.scan_channels(chans, CFG, prescan=True, device="cpu")
    for d in one:
        got = dict(reps[d["channel"]])
        del got["worker"]
        assert got == d
    assert [reps[f"ch{i}"]["n_cell_id"] for i in CELLS] == list(CELLS.values())
    assert reps["ch1"]["mib"] is None
    assert not reps["ch1"]["prescan"]["detected"]


def test_total_equals_the_reference_cell_count(captures, first_run):
    d, _ = captures
    _, lines = first_run
    totals = sorted((x["worker"], x["multihost_total_cells"]) for x in lines
                    if "multihost_total_cells" in x)
    cfg_r = RefPhyConfig(n_rb_dl=6)
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    n_ref = sum(scan_ref(read_iq_ref(str(d / f"ch{i}.fc32")), cfg_r,
                         max_si_subframes=0).mib is not None
                for i in range(4))
    mp.undo()
    assert n_ref == len(CELLS)
    assert totals == [(0, n_ref), (1, n_ref)]


def test_per_worker_checkpoints(first_run):
    ckpt, lines = first_run
    for w in (0, 1):
        with open(f"{ckpt}.w{w}") as f:
            state = json.load(f)
        assert sorted(state) == [f"ch{i}" for i in range(w, 4, 2)]
        for c, r in state.items():
            want = dict(_reports(lines)[c])
            del want["worker"]
            assert r == want


def test_relaunch_rescans_only_unfinished_channels(captures, first_run,
                                                   tmp_path):
    d, specs = captures
    ckpt, lines = first_run
    mine = str(tmp_path / "scan.ckpt")
    for w in (0, 1):
        with open(f"{ckpt}.w{w}") as f:
            state = json.load(f)
        if w == 1:
            del state["ch3"]          # the worker died before ch3 was done
        with open(f"{mine}.w{w}", "w") as f:
            json.dump(state, f)
    # only ch3's capture is still there: a re-scan of any other channel
    # would report a read error instead of the checkpointed result
    gone = [s if s.startswith("ch3=") else s.split("=")[0] + "=/nonexistent"
            for s in specs]
    rc, again, err = _multihost(gone, "--checkpoint", mine)
    assert rc == 0, err
    assert _reports(again) == _reports(lines)
    with open(f"{mine}.w1") as f:
        assert sorted(json.load(f)) == ["ch1", "ch3"]


def test_a_failed_worker_fails_the_job(capsys):
    """Workers that exit non-zero make the coordinator return 1 with the
    reference's message (here both fail to parse a capture spec)."""
    with pytest.raises(SystemExit) as e:
        scanner.main(["no-label-spec", "--multihost", "2", "--device", "cpu",
                      "--port", str(_free_port())])
    assert e.value.code == 1
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("{")]
    assert out == [{"multihost_error": "worker rcs [1, 1]; relaunch to "
                                       "resume from checkpoints"}]


def test_dryrun_multichip_on_the_cpu(capsys):
    res = dryrun_multichip(2, device="cpu", n_rb=6)
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "dryrun_multichip(2):"
    assert out.splitlines()[-1] == "dryrun_multichip(2) - OK"
    assert [r.rank for r in res] == [0, 1]
    for r in res:
        lines = r.value["lines"]
        assert len(lines) == 12 and all(ln.endswith("- OK") for ln in lines)
        assert [ln.split()[1] for ln in lines] == ["1x2"] * 6 + ["2x1"] * 6
        assert "rv0 alone 0/2, combined n_ok=2/2" in lines[4]
        assert "rv0 alone 0/1, combined n_ok=1/1" in lines[10]
        assert set(r.launches.values()) == {0}   # plain versions on the CPU


def test_scaling_cli_on_the_cpu(capsys):
    out = scaling.main(["--nproc", "2", "--device", "cpu", "--n-rb", "6",
                        "--mcs", "9", "--per-dev", "1", "--reps", "1"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert out["unit"] == "samples/s (CPU dry run)" and out["card"] == "cpu"
    assert out["backend"] == "gloo"
    assert [r["n_dev"] for r in out["results"]] == [1, 2]
    for r in out["results"]:
        assert r["n_ok"] == r["total_sf"] == r["n_dev"]
        assert r["efficiency"] is None and r["ranks_per_card"] is None
        assert r["samples_per_s"] > 0 and r["mbit_per_s"] > 0


def test_scaling_cli_takes_the_shipped_numerics(capsys):
    """``--mdtype bf16 --demap-in bf16`` reaches the ranks' decoders."""
    out = scaling.main(["--nproc", "1", "--device", "cpu", "--n-rb", "6",
                        "--mcs", "9", "--per-dev", "1", "--reps", "1",
                        "--mdtype", "bf16", "--demap-in", "bf16"])
    assert (out["mdtype"], out["demap_in"]) == ("bf16", "bf16")
    assert [r["n_ok"] for r in out["results"]] == [1]


def test_multihost_dryrun_cli_on_the_cpu(capfd):
    multihost_dryrun.main(["--nproc", "2", "--device", "cpu"])
    out = capfd.readouterr().out
    assert out.count("global detected cells: 2") == 2
    assert out.rstrip().endswith("multihost dryrun OK")
