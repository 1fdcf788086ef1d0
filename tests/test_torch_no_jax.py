"""The PyTorch port loads no jax, nothing of the ``lteax`` package (not
even its jax-free modules or its native library: the port keeps its own
copies) and no ``cryptography`` (the card's machine has none: the port has
its own AES), nor do the ranks it spawns; its decoders, generators,
simulators, CLIs and multi-device entry points run on the card unless
asked for the CPU, NCCL is never asked to put two ranks on one card, a
failed native build raises, and chip_smoke.py refuses to run without the
port or without a CUDA device (no CPU fallback, no result printed)."""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_ENV = {**os.environ, "PYTHONPATH": str(REPO)}


def _run(code: str, cwd=REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          env=env or _ENV, capture_output=True, text=True,
                          timeout=120)


_FOREIGN = ("bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'lteax', 'cryptography'))\n"
            "assert not bad, bad\n")


def test_port_imports_no_jax():
    """Every module of the port, imported: neither jax nor lteax loaded."""
    res = _run(
        "import importlib, pkgutil, sys\n"
        "import lteax_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(lteax_torch.__path__,"
        " 'lteax_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 112, mods\n"
        "for m in ('phy.channels.phich', 'phy.channels.pucch',"
        " 'bench.ul_throughput', 'bench.snr_sweep', 'bench.config3',"
        " 'sim.ctrl_gen', 'apps.file_gen', 'apps.ctrl', 'apps.stream_scan',"
        " 'apps.recorder', 'io.native', 'utils.trace', 'phy.channels.prach',"
        " 'phy.channels.srs', 'phy.tables.prach_roots', 'stack.security',"
        " 'stack.snow3g', 'stack.nas', 'stack.rrc_proc', 'stack.rrc_meas',"
        " 'stack.rlc_am', 'stack.rlc_um', 'stack.users', 'io.pcap',"
        " 'apps.attach_sim', 'apps.rrc_attach_sim', 'stack.mac_sched',"
        " 'stack.pdcp', 'stack.cnfg_db', 'stack.gw', 'stack.timers',"
        " 'apps.enb_sim', 'apps.enb_service', 'bench.harq_throughput',"
        " 'shard.mesh', 'shard.halo', 'shard.pipeline', 'shard.scanner',"
        " 'shard.dryrun', 'bench.scaling', 'bench.multihost_dryrun'):\n"
        "    assert 'lteax_torch.' + m in mods, m\n" + _FOREIGN)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's own imports (the port, torch, numpy) load neither."""
    res = _run(
        "import runpy, sys\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "assert 'lteax_torch.pipeline' in sys.modules\n" + _FOREIGN)
    assert res.returncode == 0, res.stderr


def test_no_import_statement_names_lteax_or_jax():
    """No source line of the port or of chip_smoke.py imports them."""
    pat = re.compile(r"^\s*(from|import)\s+(lteax|jax|jaxlib|cryptography)"
                     r"(\.|\s|$)")
    files = [*sorted((REPO / "lteax_torch").rglob("*.py")),
             REPO / "chip_smoke.py"]
    assert len(files) >= 40
    bad = [f"{f.relative_to(REPO)}:{i}: {ln.strip()}" for f in files
           for i, ln in enumerate(f.read_text().splitlines(), 1)
           if pat.match(ln)]
    assert not bad, bad


@pytest.mark.parametrize("factory", ["make_batch_decoder",
                                     "make_pusch_batch_decoder",
                                     "make_batch_harq_decoder",
                                     "make_mimo_batch_decoder",
                                     "make_mimo_sic_batch_decoder"])
def test_decoders_need_a_card_unless_asked_for_the_cpu(factory):
    """Without a ``device`` and without CUDA the factory raises instead of
    running on the CPU; ``device="cpu"`` builds."""
    import torch
    import lteax_torch.pipeline as pipeline
    from lteax_torch.phy.channels.pusch import PuschAlloc
    from lteax_torch.sim.dl_gen import DlCell, harq_decoder_args
    from lteax_torch.sim.mimo_gen import MimoCell
    from lteax_torch.sim.ul_gen import UlCell
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cell = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=2)
    args = {
        "make_batch_decoder": cell.decoder_args(),
        "make_pusch_batch_decoder":
            UlCell(alloc=PuschAlloc(6, 0, 712, 2)).decoder_args(),
        "make_batch_harq_decoder": harq_decoder_args(
            [cell, dataclasses.replace(cell, subframe=2, rv=2)]),
        "make_mimo_batch_decoder":
            MimoCell(n_rb_dl=6, cfi=2, mcs=15).decoder_args(),
        "make_mimo_sic_batch_decoder":
            MimoCell(n_rb_dl=6, cfi=2, mcs=15).decoder_args(),
    }[factory]
    make = getattr(pipeline, factory)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(*args)
    assert make(*args, device="cpu").device == torch.device("cpu")


def test_scan_needs_a_card_unless_asked_for_the_cpu():
    """``scan`` of a numpy capture runs on the current CUDA device: without
    one it raises unless the caller passes ``device="cpu"``; a torch
    tensor is scanned on its own device."""
    import numpy as np
    import torch
    from lteax_torch.apps.file_scan import scan
    from lteax_torch.phy.config import PhyConfig
    from lteax_torch.sim.cell_gen import Cell, capture
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = PhyConfig(n_rb_dl=6)
    iq = capture(Cell(n_rb_dl=6, n_cell_id=137), 0.012, offset=300,
                 device="cpu").iq
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scan(iq, cfg, max_si_subframes=0)
    on_cpu = scan(iq, cfg, max_si_subframes=0, device="cpu")
    assert on_cpu.n_cell_id == 137 and on_cpu.mib is not None
    got = scan(torch.from_numpy(np.array(iq)), cfg, max_si_subframes=0)
    assert (got.n_cell_id, got.mib) == (on_cpu.n_cell_id, on_cpu.mib)


def test_generator_needs_a_card_unless_asked_for_the_cpu():
    """``cell_gen.generate`` and ``capture`` modulate on the current CUDA
    device: without one they raise unless the caller passes
    ``device="cpu"``."""
    import torch
    from lteax_torch.sim.cell_gen import Cell, capture, generate
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cell = Cell(n_rb_dl=6, n_cell_id=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(cell, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture(cell, 0.002)
    x = generate(cell, 1, device="cpu")
    assert x.shape == (cell.cfg.n_samps_subframe,) and x.dtype == "complex64"
    assert capture(cell, 0.002, device="cpu").iq.shape == (3840,)


def _ulctrl_receivers():
    """(name, call(x, device), input array) for each UL control receiver
    that takes the reference's numpy input."""
    import numpy as np
    from lteax_torch.phy.channels import prach, pucch, srs
    grid = np.zeros((14, 6 * 12), np.complex64)
    wide = np.zeros((14, 25 * 12), np.complex64)
    res = np.zeros((2, 7, 12), np.complex64)
    return [
        ("detect_prach", lambda x, d: prach.detect_prach(x, 129, 13,
                                                         device=d),
         np.zeros(24576, np.complex64)),
        ("pucch_format1_decode", lambda x, d: pucch.pucch_format1_decode(
            x, 5, 0, device=d), res),
        ("rm20_decode", lambda x, d: pucch.rm20_decode(x, 5, device=d),
         np.ones(20, np.float32)),
        ("pucch_format2_decode", lambda x, d: pucch.pucch_format2_decode(
            x, 5, 0, 0x46, 5, device=d), res),
        ("pucch_format2ab_decode", lambda x, d:
         pucch.pucch_format2ab_decode(x, 5, 0, 0x46, 5, 1, device=d), res),
        ("pucch_extract", lambda x, d: pucch.pucch_extract(x, 0, 6,
                                                           device=d), grid),
        ("pucch_present", lambda x, d: pucch.pucch_present(x, 0, 6,
                                                           device=d), grid),
        ("srs_detect", lambda x, d: srs.srs_detect(x, 25, 5, 16, device=d),
         wide),
        ("srs_estimate_channel", lambda x, d: srs.srs_estimate_channel(
            x, 25, 5, 16, device=d), wide),
    ]


@pytest.mark.parametrize("i", range(9))
def test_ulctrl_receivers_need_a_card_unless_asked_for_the_cpu(i):
    """The PRACH, PUCCH and SRS receivers take the reference's numpy input
    onto the current CUDA device: without one they raise unless the caller
    passes ``device="cpu"``; a torch tensor is decoded on its own device."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    name, call, x = _ulctrl_receivers()[i]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(x, None)
    call(x, "cpu")
    call(torch.from_numpy(x), None)


@pytest.mark.parametrize("app", ["attach_sim", "rrc_attach_sim"])
def test_simulators_need_a_card_unless_asked_for_the_cpu(app):
    """``run`` raises without a CUDA device before it does any work unless
    the caller passes ``device="cpu"`` (``tests/test_torch_attach.py``
    runs both on the CPU)."""
    import importlib
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"lteax_torch.apps.{app}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(verbose=False)


def _enb_entry(name: str, device):
    """Build one of the eNB entry points at 6 PRB on ``device``."""
    from lteax_torch.apps.enb_service import EnbService
    from lteax_torch.apps.enb_sim import EnbSim, UeSim
    from lteax_torch.apps.file_gen import GenConfig
    gc = GenConfig(n_rb_dl=6, n_cell_id=77)
    if name == "EnbSim":
        return EnbSim(gc, device=device)
    if name == "UeSim":
        return UeSim(gc, 0x100, bytes(32), device=device)
    svc = EnbService(port=0, device=device)
    svc.close()
    return svc


@pytest.mark.parametrize("name", ["EnbSim", "UeSim", "EnbService"])
def test_enb_entry_points_need_a_card_unless_asked_for_the_cpu(name):
    """``EnbSim``, ``UeSim`` and ``EnbService`` put their receivers on the
    current CUDA device: without one they raise before any work (no
    socket opened) unless the caller passes ``device="cpu"``; the service
    hands its explicit device to the eNB and to every UE."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _enb_entry(name, None)
    obj = _enb_entry(name, "cpu")
    assert obj.device == torch.device("cpu")
    if name == "EnbService":
        assert obj._cmd_start([]).startswith("started")
        assert obj.enb.device == obj.device


@pytest.mark.parametrize("cli", ["file_gen", "file_scan", "stream_scan",
                                 "dl_throughput", "ul_throughput",
                                 "mimo_throughput", "attach_sim",
                                 "rrc_attach_sim", "enb_service",
                                 "harq_throughput"])
def test_clis_need_a_card_unless_asked_for_the_cpu(cli, tmp_path):
    """Each new CLI, and each bench CLI, raises without a CUDA device
    unless ``--device cpu``, before it does any work."""
    import torch
    from lteax_torch.apps import (attach_sim, enb_service, file_gen,
                                  file_scan, rrc_attach_sim, stream_scan)
    from lteax_torch.bench import (dl_throughput, harq_throughput,
                                   mimo_throughput, ul_throughput)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cap = str(tmp_path / "cap.fc32")
    if cli != "file_gen":
        file_gen.main(["--out", cap, "--frames", "2", "--device", "cpu"])
    main, argv = {
        "file_gen": (file_gen.main, ["--out", str(tmp_path / "x.fc32"),
                                     "--frames", "2"]),
        "file_scan": (file_scan.main, [cap]),
        "stream_scan": (stream_scan.main, [cap, "--window-sf", "20"]),
        "dl_throughput": (dl_throughput.main, ["--batch", "1"]),
        "ul_throughput": (ul_throughput.main, ["--batch", "1"]),
        "mimo_throughput": (mimo_throughput.main, ["--batch", "1"]),
        "attach_sim": (attach_sim.main, []),
        "rrc_attach_sim": (rrc_attach_sim.main, []),
        "enb_service": (enb_service.main, ["--port", "0"]),
        "harq_throughput": (harq_throughput.main, ["--batch", "1"]),
    }[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not (tmp_path / "x.fc32").exists()
    if cli in ("file_gen", "file_scan", "stream_scan", "attach_sim",
               "rrc_attach_sim"):
        main([*argv, "--device", "cpu"])


def test_failed_native_build_raises():
    """A compiler that fails makes the native reader raise with its
    output (no numpy fallback); ``available()`` says False."""
    res = _run(
        "import pytest\n"
        "from lteax_torch.io import native\n"
        "with pytest.raises(RuntimeError, match='false failed') as e:\n"
        "    native.read_iq_native('chip_smoke.py', 'sc8', count=4)\n"
        "assert not native.available()\n"
        "with pytest.raises(RuntimeError):\n"
        "    native.IqTcpSource()\n"
        "print('raised')\n", env={**_ENV, "CXX": "false"})
    assert res.returncode == 0 and "raised" in res.stdout, res.stderr
    assert not list((REPO / "build" / "lteax_torch").glob("*.tmp"))


def test_port_never_loads_the_reference_native_library():
    """The port builds its own copy of the C++ sources: no path of the
    port names the reference's committed ``libiqreader.so`` or its
    ``lteax/native`` directory."""
    res = _run(
        "import os\n"
        "from lteax_torch.io import native\n"
        "assert native.available()\n"
        "maps = open(f'/proc/{os.getpid()}/maps').read()\n"
        "assert 'lteax/native' not in maps, maps\n"
        "assert 'build/lteax_torch/libiqreader_' in maps\n")
    assert res.returncode == 0, res.stderr


def test_chip_smoke_fails_without_cuda():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env={**_ENV, "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory with nothing else of the repo, it fails."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    for line in res.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_spawned_ranks_load_no_jax():
    """A rank of ``shard.mesh.spawn`` is a fresh interpreter: it loads
    neither jax nor lteax, whatever its parent loaded."""
    import torch_shard_ranks
    from lteax_torch.shard.mesh import spawn
    res = spawn(torch_shard_ranks.foreign_modules, 2, "cpu", None)
    assert [r.value for r in res] == [[], []]


def _sharded_factory_args(name: str):
    from lteax_torch.phy.channels.pusch import PuschAlloc
    from lteax_torch.sim.dl_gen import DlCell, harq_decoder_args
    from lteax_torch.sim.mimo_gen import MimoCell
    from lteax_torch.sim.ul_gen import UlCell
    cell = DlCell(n_rb_dl=6, n_cell_id=150, mcs=9, cfi=2)
    return {
        "make_sharded_decoder": cell.decoder_args(),
        "make_sharded_acquire_decoder": cell.decoder_args(),
        "make_sharded_pusch_decoder":
            UlCell(alloc=PuschAlloc(6, 0, 712, 2)).decoder_args(),
        "make_sharded_harq_decoder": harq_decoder_args(
            [cell, dataclasses.replace(cell, subframe=2, rv=2)]),
        "make_sharded_mimo_decoder":
            MimoCell(n_rb_dl=6, cfi=2, mcs=15).decoder_args(),
        "make_sharded_mimo_sic_decoder":
            MimoCell(n_rb_dl=6, cfi=2, mcs=15).decoder_args(),
    }[name]


@pytest.mark.parametrize("factory", ["make_sharded_decoder",
                                     "make_sharded_acquire_decoder",
                                     "make_sharded_pusch_decoder",
                                     "make_sharded_harq_decoder",
                                     "make_sharded_mimo_decoder",
                                     "make_sharded_mimo_sic_decoder"])
def test_sharded_decoders_need_a_card_unless_asked_for_the_cpu(factory):
    """On a mesh of CPU ranks a sharded factory without ``device`` raises
    instead of decoding on the CPU; ``device="cpu"`` builds."""
    import torch
    from lteax_torch.shard import pipeline as sp
    from lteax_torch.shard.mesh import make_mesh, process_group
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    make = getattr(sp, factory)
    args = _sharded_factory_args(factory)
    with process_group(device="cpu"):
        mesh = make_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(mesh, *args)
        assert make(mesh, *args, device="cpu").device == torch.device("cpu")


def _multi_device_entry(name: str, device):
    """Call one multi-device entry point on ``device`` (None: the card)."""
    import torch_shard_ranks
    from lteax_torch.apps import scanner
    from lteax_torch.bench import multihost_dryrun, scaling
    from lteax_torch.shard.dryrun import dryrun_multichip
    from lteax_torch.shard.mesh import make_mesh, process_group, spawn
    dev = [] if device is None else ["--device", device]
    if name == "make_mesh":
        with process_group(device="cpu"):
            return make_mesh(device=device)
    if name == "process_group":
        with process_group(device=device):
            return None
    if name == "spawn":
        return spawn(torch_shard_ranks.foreign_modules, 1, device, None)
    if name == "dryrun_multichip":
        return dryrun_multichip(1, device=device, n_rb=6, verbose=False)
    if name == "bench.scaling":
        return scaling.main(["--n-rb", "6", "--mcs", "9", "--per-dev", "1",
                             "--reps", "1", *dev])
    if name == "bench.multihost_dryrun":
        return multihost_dryrun.main(["--nproc", "1", *dev])
    return scanner.main(["a=/nonexistent", "--multihost", "2", *dev])


@pytest.mark.parametrize("name", ["make_mesh", "process_group", "spawn",
                                  "dryrun_multichip", "bench.scaling",
                                  "bench.multihost_dryrun",
                                  "apps.scanner --multihost"])
def test_multi_device_entry_points_need_a_card_unless_asked_for_the_cpu(
        name):
    """Without a CUDA device each multi-device entry point raises before
    it starts a rank or a worker; asked for the CPU, each runs (the
    scanner's coordinator is left out: its workers would scan)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _multi_device_entry(name, None)
    if name != "apps.scanner --multihost":
        _multi_device_entry(name, "cpu")


@pytest.mark.parametrize("n_ranks,backend,ok", [
    (1, "nccl", True), (2, "nccl", False), (2, None, False),
    (2, "gloo", True), (1, None, True)])
def test_nccl_needs_a_card_a_rank(monkeypatch, n_ranks, backend, ok):
    """With one card, NCCL (the default on cards) takes one rank and
    refuses two, naming ``backend="gloo"``; gloo takes both.  Nothing
    switches backend for the caller."""
    import torch
    from lteax_torch.shard.mesh import resolve_backend
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if ok:
        assert resolve_backend("cuda", n_ranks, backend) == \
            (backend or "nccl")
    else:
        with pytest.raises(ValueError, match='backend="gloo"'):
            resolve_backend("cuda", n_ranks, backend)


@pytest.mark.parametrize("entry", ["spawn", "dryrun_multichip",
                                   "bench.scaling"])
def test_nccl_on_the_cpu_raises_naming_gloo(entry):
    """Asked for the CPU with NCCL, the entry points raise before starting
    a rank: NCCL has no CPU ranks, gloo does."""
    import torch_shard_ranks
    from lteax_torch.bench import scaling
    from lteax_torch.shard.dryrun import dryrun_multichip
    from lteax_torch.shard.mesh import spawn
    call = {"spawn": lambda: spawn(torch_shard_ranks.foreign_modules, 2,
                                   "cpu", "nccl"),
            "dryrun_multichip": lambda: dryrun_multichip(
                2, device="cpu", backend="nccl"),
            "bench.scaling": lambda: scaling.main(
                ["--nproc", "2", "--device", "cpu", "--backend", "nccl"])}
    with pytest.raises(ValueError, match='backend="gloo"'):
        call[entry]()
