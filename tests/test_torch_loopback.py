"""Config #1 (``configs/config1_loopback_1p4.yaml``: 1.4 MHz, cell 214, one
port, 8 frames, file_gen then file_scan) through the port's CLIs on the
CPU, against the reference.

The reference's ``file_gen.main`` writes the capture and its ``scan``
reports on it; the port's ``file_scan.main --device cpu`` prints a report
whose parsed dict equals the reference's (as numbers: the port's CFO of a
clean capture prints as -0.0, the reference's as 0.0, ROADMAP §3), with
cell 214, the MIB, SIB1 and SIB2 and no SI CRC failure.  The same holds
for the file the port's own ``file_gen`` CLI writes, in fc32 and in sc8
(the sc8 reports against the reference's scan of its own sc8 file).  The
reference's OFDM is pinned to its FFT route (``LTEAX_OFDM_DFT=fft``)."""

import json

import numpy as np
import pytest
import torch
import yaml

from lteax.apps import file_gen as fg_ref
from lteax.apps.file_scan import scan as scan_ref
from lteax.io import iq as iq_ref
from lteax.phy.config import PhyConfig as RefPhyConfig

from lteax_torch.apps import file_gen, file_scan
from lteax_torch.io.iq import read_iq

CONFIG = yaml.safe_load(open("configs/config1_loopback_1p4.yaml"))
GEN_ARGS = ["--n-rb", str(CONFIG["n_rb_dl"]),
            "--cell-id", str(CONFIG["n_cell_id"]),
            "--n-ant", str(CONFIG["n_ant"]),
            "--frames", str(CONFIG["n_frames"])]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The reference's capture in fc32 and sc8 and its reports on each."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("config1")
    ref_fc32, ref_sc8 = str(d / "ref.fc32"), str(d / "ref.sc8")
    fg_ref.main(["--out", ref_fc32, *GEN_ARGS])
    iq_ref.write_iq(ref_sc8, iq_ref.read_iq(ref_fc32), "sc8")
    cfg_r = RefPhyConfig(n_rb_dl=CONFIG["n_rb_dl"])
    reports = {fmt: json.loads(scan_ref(iq_ref.read_iq(p, fmt),
                                        cfg_r).to_json())
               for fmt, p in (("fc32", ref_fc32), ("sc8", ref_sc8))}
    yield {"dir": d, "fc32": ref_fc32, "sc8": ref_sc8, "reports": reports}
    torch.set_num_threads(n)
    mp.undo()


def _port_report(capsys, path: str, fmt: str) -> dict:
    capsys.readouterr()
    file_scan.main([path, "--n-rb", str(CONFIG["n_rb_dl"]), "--fmt", fmt,
                    "--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _assert_config1(rep: dict) -> None:
    assert rep["n_cell_id"] == CONFIG["n_cell_id"]
    assert rep["n_ant"] == CONFIG["n_ant"]
    assert rep["mib"]["n_rb_dl"] == CONFIG["n_rb_dl"]
    assert rep["sib1"]["tac"] == 0x1234 and rep["sib2"] is not None
    assert rep["sib_crc_fails"] == 0


def test_reference_file_scans_as_the_reference_does(files, capsys):
    ref = files["reports"]["fc32"]
    _assert_config1(ref)
    got = _port_report(capsys, files["fc32"], "fc32")
    assert got == ref


@pytest.mark.parametrize("fmt", ["fc32", "sc8"])
def test_port_file_gen_cli_file_scans_as_the_reference_does(files, capsys,
                                                            fmt):
    path = str(files["dir"] / f"port.{fmt}")
    file_gen.main(["--out", path, *GEN_ARGS, "--fmt", fmt,
                   "--device", "cpu"])
    assert "wrote 153600 samples (8 frames, 1.92 Msps)" in \
        capsys.readouterr().out
    x, x_ref = read_iq(path, fmt), read_iq(files[fmt], fmt)
    assert x.shape == x_ref.shape == (153600,)
    # fc32: the same samples within 1e-5 of the peak; sc8: at most one
    # quantisation step apart, where a value sits at a rounding boundary
    tol = 1e-5 * np.abs(x_ref).max() if fmt == "fc32" else 1.01 / 128
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=tol)
    got = _port_report(capsys, path, fmt)
    _assert_config1(got)
    assert got == files["reports"][fmt]
