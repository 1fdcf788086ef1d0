"""Shared checks of ``tests/test_torch_si.py`` and
``tests/test_torch_si_sfbc.py``: one reference capture
(``lteax.apps.file_gen.generate``) scanned with SI by the reference's
``scan(x, cfg)`` and by the port's on the CPU, then the reports, the SI
decodes and the control-channel stages compared.

Tolerances: integer fields, the MIB, SIB1, SIB2, the other SIBs, paging
and ``sib_crc_fails`` equal; the floats as ``tests/test_torch_scan.py``
holds them (CFO 1 Hz, RSRP and SNR 0.1 dB, EVM 0.05 points); the decoded
SI transport blocks equal bit for bit; the PCFICH CFI equal; every PDCCH
candidate's Viterbi bits equal on the same logical LLRs, its de-matched
LLRs within 1e-6 of the largest (both sum the repeats in the order sent).
"""

import json

import jax.numpy as jnp
import numpy as np
import torch

from lteax.apps import file_gen
from lteax.apps.file_scan import scan as scan_ref
from lteax.phy.channels import pcfich as pcfich_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.fec import ratematch as rm_ref
from lteax.phy.fec.viterbi import viterbi_decode_tb_batch as viterbi_ref

import lteax_torch.apps.file_scan as fs
from lteax_torch import host
from lteax_torch.phy import sync
from lteax_torch.phy.channels import pcfich, pdcch
from lteax_torch.phy.channels.dci import dci_1a_size, dci_1c_size
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.fec.viterbi import viterbi_decode_tb_batch
from lteax_torch.phy.grid import pcfich_flat_idx
from lteax_torch.phy.ofdm import samples_to_subframe

N_RB = 6
CFG, CFG_R = PhyConfig(n_rb_dl=N_RB), RefPhyConfig(n_rb_dl=N_RB)
INT_FIELDS = ("n_cell_id", "n_id_1", "n_id_2", "frame_start", "n_ant", "sfn",
              "sib_crc_fails")
EXACT_KEYS = INT_FIELDS + ("mib", "sib1", "sib2", "sibs", "paging")


def scan_both(gc: "file_gen.GenConfig") -> dict:
    """The reference capture and both scans of it, with the port's reads."""
    x = np.array(file_gen.generate(gc))
    ref = scan_ref(x, CFG_R)
    host.READS = 0
    got = fs.scan(torch.from_numpy(x), CFG)
    return {"x": x, "ref": ref, "got": got, "reads": host.READS}


def assert_same_report(got, ref) -> None:
    g, r = json.loads(got.to_json()), json.loads(ref.to_json())
    assert g.keys() == r.keys()
    for k in EXACT_KEYS:
        assert g[k] == r[k], k
    assert abs(got.cfo_hz - ref.cfo_hz) < 1.0
    assert abs(got.rsrp_dbfs - ref.rsrp_dbfs) < 0.1
    assert abs(got.snr_db - ref.snr_db) < 0.1
    assert abs(got.evm_pct - ref.evm_pct) < 0.05


def assert_same_si_decodes(got, ref) -> None:
    assert len(got.si_decodes) == len(ref.si_decodes) > 0
    for a, b in zip(got.si_decodes, ref.si_decodes):
        for k in ("sf_index", "sf", "ctrl", "prbs", "tbs", "rv"):
            assert a[k] == b[k], k
        np.testing.assert_array_equal(a["tb"], np.asarray(b["tb"]))


def subframe(scanned: dict, sf_index: int, n_ant: int | None = None):
    """The port's receiver of one subframe of the scanned capture, over
    the cell's ports (or the first ``n_ant``)."""
    got = scanned["got"]
    nsf = CFG.n_samps_subframe
    x = torch.from_numpy(scanned["x"]).to(torch.complex64)
    # the scan's CFO correction, then the subframe's grid
    x = sync.apply_cfo(x, torch.tensor(got.cfo_hz), CFG.fs)
    start = got.frame_start + sf_index * nsf
    g = samples_to_subframe(x[start:start + nsf][None], CFG)[0]
    cfg_c = PhyConfig(n_rb_dl=N_RB, n_ant=got.n_ant)
    return fs._Subframe(g, CFG, cfg_c, got.n_cell_id, sf_index % 10,
                        n_ant or got.n_ant)


def assert_same_cfi(sub) -> int:
    """PCFICH decode of the same LLRs on both sides."""
    llr = sub.llrs(pcfich_flat_idx(sub.cfg_c, sub.cid))
    cfi, scores = pcfich.pcfich_decode(llr, sub.cid, sub.sf)
    cfi_r, scores_r = pcfich_ref.pcfich_decode(jnp.asarray(llr.numpy()),
                                               sub.cid, sub.sf)
    assert int(cfi) == int(cfi_r)
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_r),
                               rtol=1e-5, atol=1e-5)
    return int(cfi)


def assert_same_candidates(sub, ctrl: int, ng: float, fmt: str,
                           rnti: int) -> None:
    """Every search-space candidate of one DCI format: the port's batched
    de-match and Viterbi against the reference's, on the same logical
    LLRs."""
    logical, n_cces = sub.pdcch_logical(ctrl, ng)
    size = {"1a": dci_1a_size, "1c": dci_1c_size}[fmt](N_RB)
    d_len = size + 16
    cands = pdcch.search_candidates(n_cces, rnti, None)
    assert cands
    d = pdcch.candidate_llrs(logical, cands, d_len)
    bits = viterbi_decode_tb_batch(d, d_len).numpy()
    lg = jnp.asarray(logical.numpy())
    stacks = []
    for start, l_agg in cands:
        e_len = l_agg * pdcch.REG_PER_CCE * pdcch.BITS_PER_REG
        lo = start * pdcch.REG_PER_CCE * pdcch.BITS_PER_REG
        stacks.append(np.asarray(rm_ref.rate_unmatch(
            lg[lo:lo + e_len], rm_ref.conv_rm_indices(d_len, e_len),
            d_len)))
    stacks = np.stack(stacks)
    np.testing.assert_allclose(d.numpy(), stacks, rtol=0,
                               atol=1e-6 * np.abs(stacks).max())
    np.testing.assert_array_equal(bits, np.asarray(viterbi_ref(
        jnp.asarray(stacks), d_len)))
