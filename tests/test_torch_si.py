"""The port's capture scan with SI decode against the reference's
``lteax.apps.file_scan.scan(x, cfg)`` on the CPU: a ``file_gen`` capture
at 6 PRB, one antenna, SI granted by DCI 1A, 4 frames (SIB1 and SIB2 each
TBS 224 over PRBs 0-5, a rate match that wraps its circular buffer).

What is compared and to which tolerance: ``tests/torch_si_compare.py``.
The reference's OFDM demod is pinned to its FFT route
(``LTEAX_OFDM_DFT=fft``)."""

import pytest
import torch

from lteax.apps import file_gen

from torch_si_compare import (N_RB, assert_same_candidates, assert_same_cfi,
                              assert_same_report, assert_same_si_decodes,
                              scan_both, subframe)

SI_RNTI = 0xFFFF


@pytest.fixture(scope="module")
def scanned():
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = scan_both(file_gen.GenConfig(n_rb_dl=N_RB, n_cell_id=77, n_ant=1,
                                       n_frames=4))
    yield out
    torch.set_num_threads(n)
    mp.undo()


def test_report_matches_reference(scanned):
    got, ref = scanned["got"], scanned["ref"]
    assert_same_report(got, ref)
    assert got.sib1 is not None and got.sib2 is not None
    assert (got.n_cell_id, got.n_ant, got.sib_crc_fails) == (77, 1, 0)
    assert got.sib1.tac == 0x1234 and got.paging is None


def test_si_decodes_match_reference(scanned):
    assert_same_si_decodes(scanned["got"], scanned["ref"])
    assert [(d["sf_index"], d["tbs"], d["rv"])
            for d in scanned["got"].si_decodes] == [(5, 224, 0), (15, 224, 0)]


def test_host_reads(scanned):
    """4 to the MIB; subframe 9 of frames 0 and 1 (CFI, 1C): 2 each;
    subframe 5 of frames 0 and 1 (CFI, 1A, TB): 3 each."""
    assert scanned["reads"] == 4 + 2 * 2 + 2 * 3


@pytest.mark.parametrize("sf_index", [5, 15])
def test_control_stages_match_reference(scanned, sf_index):
    sub = subframe(scanned, sf_index)
    cfi = assert_same_cfi(sub)
    ctrl = cfi + 1                             # 6 PRB: one more symbol
    assert ctrl == scanned["got"].si_decodes[sf_index // 10]["ctrl"]
    assert_same_candidates(sub, ctrl, scanned["got"].mib.phich_resource,
                           "1a", SI_RNTI)
