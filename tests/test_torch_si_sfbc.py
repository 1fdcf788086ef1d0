"""The port's capture scan with SI decode and paging against the
reference's ``lteax.apps.file_scan.scan(x, cfg)`` on the CPU: a
``file_gen`` capture at 6 PRB, two antennas (SFBC on the PCFICH, PDCCH
and PDSCH), SI granted by DCI 1C, two S-TMSIs paged in subframe 9, 4
frames.

What is compared and to which tolerance: ``tests/torch_si_compare.py``.
The reference's OFDM demod is pinned to its FFT route
(``LTEAX_OFDM_DFT=fft``)."""

import pytest
import torch

from lteax.apps import file_gen

from torch_si_compare import (N_RB, assert_same_candidates, assert_same_cfi,
                              assert_same_report, assert_same_si_decodes,
                              scan_both, subframe)
from torch_compile_cache import compile_once

SI_RNTI, P_RNTI = 0xFFFF, 0xFFFE
TMSI = (0x1234567, 0x0200000042)


@pytest.fixture(scope="module", autouse=True)
def _compile_once():
    """The reference's eager code compiles each program once
    (``torch_compile_cache``)."""
    with compile_once():
        yield


@pytest.fixture(scope="module")
def scanned():
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = scan_both(file_gen.GenConfig(n_rb_dl=N_RB, n_cell_id=404, n_ant=2,
                                       n_frames=4, si_dci="1c",
                                       paging_tmsi=TMSI))
    yield out
    torch.set_num_threads(n)
    mp.undo()


def test_report_matches_reference(scanned):
    got, ref = scanned["got"], scanned["ref"]
    assert_same_report(got, ref)
    assert got.sib1 is not None and got.sib2 is not None
    assert (got.n_cell_id, got.n_ant, got.sib_crc_fails) == (404, 2, 0)
    assert got.paging == [hex(t) for t in TMSI]


def test_si_decodes_match_reference(scanned):
    assert_same_si_decodes(scanned["got"], scanned["ref"])


def test_host_reads(scanned):
    """4 to the MIB; paging found in subframe 9 of frame 0 (CFI, 1C, TB):
    3; subframe 5 of frames 0 and 1 (CFI, 1A, 1C, TB): 4 each."""
    assert scanned["reads"] == 4 + 3 + 2 * 4


@pytest.mark.parametrize("sf_index,fmt,rnti", [(5, "1c", SI_RNTI),
                                               (9, "1c", P_RNTI)])
def test_control_stages_match_reference(scanned, sf_index, fmt, rnti):
    sub = subframe(scanned, sf_index)
    if rnti == P_RNTI:                 # paging is received on port 0 alone
        sub = subframe(scanned, sf_index, n_ant=1)
    ctrl = assert_same_cfi(sub) + 1
    assert_same_candidates(sub, ctrl, scanned["got"].mib.phich_resource,
                           fmt, rnti)
