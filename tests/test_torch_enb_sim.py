"""The port's eNB simulator (``lteax_torch.apps.enb_sim``: ``EnbSim``,
``UeSim``) against the reference's, stage by stage, on the CPU at 6 PRB.

The reference runs once per module (``reference`` fixture), without an
attach: one frame of ``EnbSim.tti_grid`` with SRB and DRB SDUs queued for
two UEs and an SR pending; ``UeSim.handle_grid`` of two UEs on four of
those grids (one with its PDSCH corrupted, one under AWGN at 3 dB); and a
UL script of ``ul_tti_grid`` / ``handle_pusch`` / ``read_phich`` (SR, DCI
0, PUSCH with a NACK on format 1, the HI on the PHICH, ACK + CQI on format
2a, CQI on format 2, ACK on format 1, NACK on format 2a).  The port runs
the same script with ``device="cpu"`` and must give:

- every DL grid within 1e-5 (absolute; unit-power resource elements) and
  the same resource elements in use, the DCIs (bits, RNTI, CCE start, L)
  exactly;
- every UE's returned STATUS bytes, ``pending_ack``, ``granted``,
  ``meas_cqi``, SDUs exactly;
- every UL grid within 1e-4 (the DFT precoding's rounding), and after each
  step the eNB's SR set, HARQ copies, scheduler queue, UL SDUs, pending
  HI bits and CQI-capped MCS exactly, and the PHICH reads.

Then the port alone runs the end-to-end assertions of the reference's
``tests/test_enb_sim.py`` and ``tests/test_handover_sim.py`` on the CPU.
"""

import numpy as np
import pytest
import torch

import lteax.apps.enb_sim as ref_sim
import lteax.phy.channels.pdcch as ref_pdcch
from lteax.apps.file_gen import GenConfig as RefGenConfig

import lteax_torch.apps.enb_sim as port_sim
import lteax_torch.phy.channels.pdcch as port_pdcch
from lteax_torch.apps.enb_sim import EnbSim, UeSim
from lteax_torch.apps.file_gen import GenConfig
from lteax_torch.phy.channels import prach
from lteax_torch.phy.channels import pucch as pucch_mod
from lteax_torch.stack import security
from lteax_torch.stack.mac_sched import CQI_TO_MCS
from lteax_torch.stack.rrc_dedicated import MeasResultEutra
from lteax_torch.stack.rrc_proc import EnbRrc, UeRrc
from lteax_torch.stack.users import Hss, UserManager

K1 = bytes(range(32))
K2 = bytes(range(1, 33))
DL_TOL = 1e-5
UL_TOL = 1e-4
CPU = {"device": "cpu"}
PKGS = {"ref": (ref_sim, RefGenConfig, ref_pdcch, {}),
        "port": (port_sim, GenConfig, port_pdcch, CPU)}


@pytest.fixture(scope="module")
def env():
    """One torch thread; the reference's fft DFTs (the port's form)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_UL_DFT", "fft")
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    yield mp
    mp.undo()
    torch.set_num_threads(n)


def _corrupt(grid: np.ndarray) -> np.ndarray:
    """The PDSCH destroyed, the control region (symbols 0-2) kept."""
    g = np.array(grid)
    g[4:] += 10.0
    return g


def _awgn(grid: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nv = 10 ** (-snr_db / 10)
    return (grid + (rng.normal(size=grid.shape) + 1j * rng.normal(
        size=grid.shape)) * np.sqrt(nv / 2)).astype(np.complex64)


def dl_script(pkg: str, mp) -> dict:
    """One frame of grids with two UEs' SDUs queued and an SR pending,
    then each UE's receive on four of them."""
    sim, gcls, pdcch_mod, kw = PKGS[pkg]
    dcis = []
    encode = pdcch_mod.pdcch_encode

    def recorded(entries, *a, **k):
        ue = [(tuple(int(b) for b in np.asarray(bits)), rnti, start, l_agg)
              for bits, rnti, start, l_agg in entries if rnti < 0xFFF0]
        if ue:
            dcis.append(ue)
        return encode(entries, *a, **k)

    mp.setattr(pdcch_mod, "pdcch_encode", recorded)
    gc = gcls(n_rb_dl=6, n_cell_id=77)
    enb = sim.EnbSim(gc, **kw)
    enb.add_ue(0x100, K1)
    enb.add_ue(0x200, K2)
    enb.send_rrc(0x100, b"rrc-reconfig-ue1")
    enb.send_data(0x100, b"ip-ue1-a")
    enb.send_data(0x100, b"ip-ue1-b")
    enb.send_data(0x200, b"ip-ue2")
    enb._sr_pending.add(0x200)
    grids = [np.asarray(enb.tti_grid(0, sf)) for sf in range(10)]
    mp.setattr(pdcch_mod, "pdcch_encode", encode)
    ues = {0x100: sim.UeSim(gc, 0x100, K1, cqi_period=1, **kw),
           0x200: sim.UeSim(gc, 0x200, K2, standing_grant=False, **kw)}
    inputs = [(grids[1], 1), (grids[2], 2), (grids[3], 3),
              (_corrupt(grids[1]), 1), (_awgn(grids[4], 3.0, 7), 4)]
    rx = []
    for rnti, ue in ues.items():
        for grid, sf in inputs:
            status = ue.handle_grid(grid, sf)
            rx.append((rnti, sf, status, ue.pending_ack, ue.granted,
                       ue.meas_cqi, list(ue.data_sdus), list(ue.rrc_sdus)))
    return {"grids": grids, "dcis": dcis, "rx": rx}


def ul_script(pkg: str) -> dict:
    """The UL control loop, step by step: the UE's grid and the eNB's
    state after its receive."""
    sim, gcls, _, kw = PKGS[pkg]
    gc = gcls(n_rb_dl=6, n_cell_id=77)
    enb = sim.EnbSim(gc, **kw)
    enb.add_ue(0x100, K1, cqi_mcs=9)
    ue = sim.UeSim(gc, 0x100, K1, standing_grant=False, **kw)
    steps = []

    def state():
        return (sorted(enb._sr_pending), dict(enb._last_dl),
                list(enb.sched.ues[0x100].queue),
                list(enb.ues[0x100].ul_sdus), dict(enb._pending_hi),
                enb.sched.ues[0x100].cqi_mcs)

    def ul(sf, **set_ue):
        for k, v in set_ue.items():
            setattr(ue, k, v)
        g = ue.ul_tti_grid(sf)
        if g is not None:
            enb.handle_pusch(0x100, g, sf)
        steps.append((None if g is None else np.asarray(g), state()))

    def dl(sfn, sf, *sdus, receive=False):
        for s in sdus:
            enb.send_data(0x100, s)
        g = np.asarray(enb.tti_grid(sfn, sf))
        rx = ((ue.handle_grid(g, sf), ue.pending_ack, ue.granted,
               list(ue.data_sdus)) if receive else None)
        steps.append((g, state(), ue.read_phich(g, sf, n_seq=0), rx))

    ue.send_ul(b"ul-needs-grant")
    ul(1)                                           # SR alone
    dl(0, 2, receive=True)                          # DCI 0
    dl(0, 3, b"harq-payload")                       # a DL TB
    ul(4, pending_ack=0)                            # PUSCH + NACK (format 1)
    dl(0, 6)                                        # HI + the retransmission
    ul(7, pending_ack=1, meas_cqi=9, _cqi_due=True)  # ACK + CQI (format 2a)
    ul(8, meas_cqi=12, _cqi_due=True)               # CQI alone (format 2)
    dl(1, 1, b"more")
    ul(2, pending_ack=1)                            # ACK (format 1)
    dl(1, 3, b"nack-2a")
    ul(4, pending_ack=0, meas_cqi=7, _cqi_due=True)  # NACK + CQI (format 2a)
    return {"steps": steps}


@pytest.fixture(scope="module")
def reference(env):
    return {**dl_script("ref", env), **ul_script("ref")}


@pytest.fixture(scope="module")
def port(env):
    return {**dl_script("port", env), **ul_script("port")}


@pytest.mark.parametrize("sf", range(10))
def test_tti_grid_equals_the_reference(reference, port, sf):
    want, got = reference["grids"][sf], port["grids"][sf]
    assert got.shape == want.shape and got.dtype == np.complex64
    assert np.array_equal(got != 0, want != 0)
    assert np.max(np.abs(got - want)) <= DL_TOL


def test_dcis_equal_the_reference(reference, port):
    assert port["dcis"] == reference["dcis"]
    flat = [d for tti in port["dcis"] for d in tti]
    assert {d[1] for d in flat} == {0x100, 0x200}
    assert len(flat) >= 3


@pytest.mark.parametrize("i", range(10))
def test_handle_grid_equals_the_reference(reference, port, i):
    assert port["rx"][i] == reference["rx"][i]


def test_the_receive_cases_are_covered(port):
    """The compared receives include an ACK, a NACK, a STATUS PDU, a clean
    and a noisy CQI, and the SDUs of both UEs (UE 0x200's SR finds no free
    candidate for its DCI 0 in this frame: the UL script has the grant)."""
    rx = port["rx"]
    assert [r[3] for r in rx[:4]] == [1, 1, 1, 0]
    assert rx[2][2] is not None and rx[2][7] == [b"rrc-reconfig-ue1"]
    assert rx[1][6] == [b"ip-ue1-a", b"ip-ue1-b"]
    assert rx[0][5] == 15 and 3 <= rx[4][5] <= 9
    assert rx[-1][6] == [b"ip-ue2"] and not rx[-1][4]


@pytest.mark.parametrize("i", range(11))
def test_ul_step_equals_the_reference(reference, port, i):
    want, got = reference["steps"][i], port["steps"][i]
    assert got[1:] == want[1:]
    if want[0] is None:
        assert got[0] is None
    else:
        assert got[0].shape == want[0].shape
        assert np.max(np.abs(got[0] - want[0])) <= (
            DL_TOL if len(want) == 4 else UL_TOL)


def test_the_ul_cases_are_covered(port):
    """SR -> DCI 0; the NACK requeued and the PUSCH SDU delivered, HI 1
    read back as ACK on the next DL grid; ACK / CQI on formats 2a, 2, 1;
    the NACK on format 2a requeued."""
    s = [step[1] for step in port["steps"]]
    assert s[0][0] == [0x100] and s[1][0] == []
    assert port["steps"][1][3] == (None, None, True, [])
    assert s[2][1] and s[3][2] and s[3][3] == [b"ul-needs-grant"]
    assert s[3][4] == {0: 1}
    assert port["steps"][4][2] is True and s[4][4] == {} and s[4][1]
    assert s[5][1] == {} and s[5][5] == CQI_TO_MCS[9]
    assert s[6][5] == CQI_TO_MCS[12]
    assert s[7][1] and s[8][1] == {}
    assert s[9][1] and s[10][1] == {} and s[10][2]
    assert s[10][5] == CQI_TO_MCS[7]


# -- the reference tests' own end-to-end assertions, on the port alone -------

def _run(enb, ues, n_frames=2, drop=None):
    """Run TTIs; drop = set of (sfn, sf) grids lost before the UE."""
    for sfn in range(n_frames):
        for sf in range(10):
            grid = enb.tti_grid(sfn, sf)
            if drop and (sfn, sf) in drop:
                continue
            for rnti, ue in ues.items():
                status = ue.handle_grid(grid, sf)
                if status is not None:
                    enb.handle_status(rnti, status)


def test_two_ue_user_plane(env):
    gc = GenConfig(n_rb_dl=6, n_cell_id=77)
    enb = EnbSim(gc, **CPU)
    enb.add_ue(0x100, K1)
    enb.add_ue(0x200, K2)
    ue1 = UeSim(gc, 0x100, K1, **CPU)
    ue2 = UeSim(gc, 0x200, K2, **CPU)
    enb.send_rrc(0x100, b"rrc-reconfig-ue1")
    enb.send_data(0x100, b"ip-ue1-a")
    enb.send_data(0x100, b"ip-ue1-b")
    enb.send_data(0x200, b"ip-ue2")
    _run(enb, {0x100: ue1, 0x200: ue2})
    assert ue1.rrc_sdus == [b"rrc-reconfig-ue1"]
    assert ue1.data_sdus == [b"ip-ue1-a", b"ip-ue1-b"]
    assert ue2.data_sdus == [b"ip-ue2"]
    assert ue2.rrc_sdus == []
    assert enb.ues[0x100].srb_tx.all_acked


def test_srb_survives_lost_subframe(env):
    gc = GenConfig(n_rb_dl=6, n_cell_id=77)
    enb = EnbSim(gc, **CPU)
    enb.add_ue(0x100, K1)
    ue = UeSim(gc, 0x100, K1, **CPU)
    enb.send_rrc(0x100, b"must-arrive")
    _run(enb, {0x100: ue}, n_frames=1, drop={(0, 1)})
    assert ue.rrc_sdus == []
    enb.ues[0x100].srb_tx.poll_retransmit()
    _run(enb, {0x100: ue}, n_frames=1)
    assert ue.rrc_sdus == [b"must-arrive"]


def test_uplink_pusch_leg(env):
    gc = GenConfig(n_rb_dl=6, n_cell_id=77)
    enb = EnbSim(gc, **CPU)
    enb.add_ue(0x100, K1)
    ue = UeSim(gc, 0x100, K1, **CPU)
    for i in range(3):
        ue.send_ul(f"ul-report-{i}".encode())
    for sf in range(1, 5):
        g = ue.ul_tti_grid(sf)
        if g is None:
            break
        enb.handle_pusch(0x100, g, sf)
    assert enb.ues[0x100].ul_sdus == [b"ul-report-0", b"ul-report-1",
                                      b"ul-report-2"]


def test_ul_with_phich_feedback(env):
    gc = GenConfig(n_rb_dl=6, n_cell_id=77)
    enb = EnbSim(gc, **CPU)
    enb.add_ue(0x100, K1)
    ue = UeSim(gc, 0x100, K1, **CPU)
    ue.send_ul(b"measurement-report")
    enb.handle_pusch(0x100, ue.ul_tti_grid(2), 2)
    assert enb.ues[0x100].ul_sdus == [b"measurement-report"]
    assert ue.read_phich(enb.tti_grid(0, 3), 3, n_seq=0) is True
    assert ue.read_phich(enb.tti_grid(0, 4), 4, n_seq=0) is False


def test_rrc_attach_over_tti_loop(env):
    imsi = (0, 0, 1, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0)
    k = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
    opc = bytes.fromhex("cd63cb71954a9f4e48a5994e37a02baf")
    hss = Hss()
    hss.add_user("".join(map(str, imsi)), k.hex(), opc.hex())
    gc = GenConfig(n_rb_dl=6, n_cell_id=77)
    enb = EnbSim(gc, rrc=EnbRrc(hss, UserManager(), seed=5), **CPU)
    rnti = enb.handle_prach(rapid=7)
    ue = UeSim(gc, rnti, rrc_ue=UeRrc(imsi, k, opc), **CPU)
    ue.start_attach()

    def done():
        p = enb.rrc.proc(rnti)
        return (ue.rrc_ue.state == "connected" and p is not None
                and p.state == "attach-done")

    assert _loop(enb, ue, rnti, range(5), done), (ue.rrc_ue.state,
                                                  enb.rrc.events)
    assert ue.sec_on and enb.ues[rnti].sec_on
    assert ue.rrc_ue.ip == (10, 0, 0, 2)
    assert any(e.startswith("attach-complete") for e in enb.rrc.events)
    enb.send_data(rnti, b"post-attach-dl-ip")
    ue.send_ul(b"post-attach-ul-ip")
    _loop(enb, ue, rnti, range(5, 7))
    assert ue.data_sdus == [b"post-attach-dl-ip"]
    assert enb.ues[rnti].ul_sdus == [b"post-attach-ul-ip"]


def test_cqi_report_link_adaptation(env):
    gc = GenConfig(n_rb_dl=6, n_cell_id=77)
    enb = EnbSim(gc, **CPU)
    enb.add_ue(0x100, K1, cqi_mcs=9)
    ue = UeSim(gc, 0x100, K1, cqi_period=1, **CPU)
    ue.handle_grid(enb.tti_grid(0, 1), 1)
    assert ue.meas_cqi == 15
    g_ul = ue.ul_tti_grid(2)
    assert g_ul is not None
    enb.handle_pusch(0x100, g_ul, 2)
    assert enb.sched.ues[0x100].cqi_mcs == CQI_TO_MCS[15]
    noisy = _awgn(np.asarray(enb.tti_grid(0, 3)), 3.0, 7)
    ue.handle_grid(noisy, 3)
    assert ue.meas_cqi is not None and 3 <= ue.meas_cqi <= 9
    enb.handle_pusch(0x100, ue.ul_tti_grid(4), 4)
    assert enb.sched.ues[0x100].cqi_mcs == CQI_TO_MCS[ue.meas_cqi]
    assert enb.sched.ues[0x100].cqi_mcs < CQI_TO_MCS[15]


def test_pucch_sr_grant_and_harq_ack_loop(env):
    gc = GenConfig(n_rb_dl=6, n_cell_id=77)
    enb = EnbSim(gc, **CPU)
    enb.add_ue(0x100, K1)
    ue = UeSim(gc, 0x100, K1, standing_grant=False, **CPU)
    ue.send_ul(b"ul-needs-grant")
    assert not ue.granted
    g_ul = ue.ul_tti_grid(1)
    assert g_ul is not None and g_ul.shape == (14, 72)
    enb.handle_pusch(0x100, g_ul, 1)
    assert 0x100 in enb._sr_pending
    assert enb.ues[0x100].ul_sdus == []
    ue.handle_grid(enb.tti_grid(0, 2), 2)
    assert ue.granted
    enb.handle_pusch(0x100, ue.ul_tti_grid(3), 3)
    assert enb.ues[0x100].ul_sdus == [b"ul-needs-grant"]
    enb.send_data(0x100, b"harq-payload")
    grid = enb.tti_grid(0, 4)
    assert 0x100 in enb._last_dl
    ue.handle_grid(_corrupt(grid), 4)
    assert ue.pending_ack == 0
    enb.handle_pusch(0x100, ue.ul_tti_grid(6), 6)
    ue.handle_grid(enb.tti_grid(0, 7), 7)
    assert ue.data_sdus == [b"harq-payload"]
    assert ue.pending_ack == 1
    enb.handle_pusch(0x100, ue.ul_tti_grid(8), 8)
    assert 0x100 not in enb._last_dl


def test_simultaneous_ack_and_cqi_on_format_2a(env):
    gc = GenConfig(n_rb_dl=6, n_cell_id=77)
    enb = EnbSim(gc, **CPU)
    enb.add_ue(0x100, K1, cqi_mcs=9)
    ue = UeSim(gc, 0x100, K1, cqi_period=1, **CPU)
    enb.send_data(0x100, b"payload-awaiting-ack")
    ue.handle_grid(enb.tti_grid(0, 1), 1)
    assert ue.pending_ack == 1 and ue.meas_cqi == 15
    assert 0x100 in enb._last_dl
    g_ul = ue.ul_tti_grid(2)
    assert g_ul is not None
    assert not pucch_mod.pucch_present(np.asarray(g_ul), port_sim.PUCCH_M_F1,
                                       6, device="cpu")
    enb.handle_pusch(0x100, g_ul, 2)
    assert 0x100 not in enb._last_dl
    assert enb.sched.ues[0x100].cqi_mcs == CQI_TO_MCS[15]


def test_nack_on_format_2a_requeues(env):
    gc = GenConfig(n_rb_dl=6, n_cell_id=77)
    enb = EnbSim(gc, **CPU)
    enb.add_ue(0x100, K1, cqi_mcs=9)
    ue = UeSim(gc, 0x100, K1, cqi_period=1, **CPU)
    rng = np.random.default_rng(3)
    enb.send_data(0x100, b"will-be-corrupted")
    grid = np.asarray(enb.tti_grid(0, 1)).astype(np.complex64)
    noisy = grid + 0.5 * (rng.normal(size=grid.shape)
                          + 1j * rng.normal(size=grid.shape)).astype(
                              np.complex64)
    ue.handle_grid(noisy, 1)
    if ue.pending_ack != 0:       # ensure the decode really failed
        ue.pending_ack = 0
    before = len(enb.sched.ues[0x100].queue)
    enb.handle_pusch(0x100, ue.ul_tti_grid(2), 2)
    assert 0x100 not in enb._last_dl
    assert len(enb.sched.ues[0x100].queue) > before


def _loop(enb, ue, rnti, sfn_range, stop=None):
    for sfn in sfn_range:
        for sf in range(10):
            g_ul = ue.ul_tti_grid(sf)
            if g_ul is not None:
                enb.handle_pusch(rnti, g_ul, sf)
            status = ue.handle_grid(enb.tti_grid(sfn, sf), sf)
            if status is not None:
                enb.handle_status(rnti, status)
            if stop is not None and stop():
                return True
    return stop() if stop is not None else True


def test_two_cell_handover_over_tti_loop(env):
    """``tests/test_handover_sim.py`` on the port: attach on the source
    cell, A3 measurement configuration, report, handover command, the
    dedicated-preamble RACH on the target cell (``detect_prach`` on the
    CPU), completion and user plane on the target cell's TTI loop."""
    imsi = (0, 0, 1, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0)
    k = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
    opc = bytes.fromhex("cd63cb71954a9f4e48a5994e37a02baf")
    hss = Hss()
    hss.add_user("".join(map(str, imsi)), k.hex(), opc.hex())
    users = UserManager()
    pci_s, pci_t, earfcn_t = 77, 201, 6300
    gc_s = GenConfig(n_rb_dl=6, n_cell_id=pci_s)
    gc_t = GenConfig(n_rb_dl=6, n_cell_id=pci_t)
    src = EnbSim(gc_s, rrc=EnbRrc(hss, users, pci=pci_s, seed=5), **CPU)
    tgt = EnbSim(gc_t, rrc=EnbRrc(hss, users, pci=pci_t, earfcn=earfcn_t,
                                  seed=6), **CPU)
    src.rrc.neighbors[pci_t] = earfcn_t
    src.rrc.neighbor_enb[pci_t] = tgt.rrc

    rnti = src.handle_prach(rapid=7)
    ue = UeSim(gc_s, rnti, rrc_ue=UeRrc(imsi, k, opc), **CPU)
    ue.start_attach()
    assert _loop(src, ue, rnti, range(5), stop=lambda: (
        ue.rrc_ue.state == "connected" and src.rrc.proc(rnti) is not None
        and src.rrc.proc(rnti).state == "attach-done"))
    k_enb_before = ue.rrc_ue.k_enb
    assert k_enb_before

    src._rrc_out(rnti, src.rrc.configure_measurements(rnti))
    assert _loop(src, ue, rnti, range(5, 8),
                 stop=lambda: ue.rrc_ue.meas_config is not None)
    ue._rrc_reply(ue.rrc_ue.measurement_report(
        1, serv_rsrp=50, serv_rsrq=20,
        neigh=(MeasResultEutra(pci_t, rsrp=62),)))
    assert _loop(src, ue, rnti, range(8, 12),
                 stop=lambda: ue.ho_pending is not None)
    assert any(e.startswith("meas-report") for e in src.rrc.events)
    assert any(e.startswith("handover-command target_pci=201")
               for e in src.rrc.events)
    assert any(e.startswith("ho-admit") for e in tgt.rrc.events)
    new_rnti = ue.rrc_ue.c_rnti
    assert new_rnti is not None and ue.rrc_ue.ho_rach is not None
    assert ue.rrc_ue.ho_target == (pci_t, earfcn_t)
    k_star = security.generate_k_enb_star(k_enb_before, pci_t, earfcn_t)
    assert ue.rrc_ue.k_enb == k_star != k_enb_before
    assert tgt.rrc.proc(new_rnti).k_enb == k_star
    assert src.rrc.proc(rnti) is None

    rng = np.random.default_rng(3)
    u_root, ncs = 129, 119
    preamble = ue.rrc_ue.ho_rach[0]
    burst = prach.generate_prach(u_root, preamble, ncs)
    noise = 10 ** (-12 / 10)
    rx = burst + (rng.standard_normal(len(burst))
                  + 1j * rng.standard_normal(len(burst))) * np.sqrt(noise / 2)
    ncp = prach.PRACH_FORMATS[0][0]
    dets = prach.detect_prach(rx[ncp:].astype(np.complex64), u_root, ncs,
                              device="cpu")
    assert dets and max(dets, key=lambda t: t[2])[0] == preamble

    tgt.admit_handover_ue(new_rnti)
    ue2 = ue.handover_retune(gc_t)
    assert ue2.device == ue.device
    assert _loop(tgt, ue2, new_rnti, range(4),
                 stop=lambda: "handover-complete" in tgt.rrc.events)
    assert tgt.rrc.proc(new_rnti).state == "attach-done"
    assert "handover-complete" not in src.rrc.events
    tgt.send_data(new_rnti, b"dl-after-ho")
    ue2.send_ul(b"ul-after-ho")
    _loop(tgt, ue2, new_rnti, range(4, 7))
    assert ue2.data_sdus == [b"dl-after-ho"]
    assert tgt.ues[new_rnti].ul_sdus == [b"ul-after-ho"]
