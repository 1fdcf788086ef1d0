"""Jax-free LTE cell captures for the scanner: PSS, SSS, CRS, PBCH,
PCFICH, PDCCH and the SI and paging PDSCH.

The counterpart of ``lteax.apps.file_gen`` (``build_subframe_grid``,
``generate``): the same grids on every resource element, in numpy and
torch, so that a machine without jax can make scanner inputs; the port's
``apps/file_gen.py`` makes its captures with it.  SIB1 goes in subframe 5 of
even frames and SI message 1 (SIB2 and, without a schedule, every extra
SIB) in subframe 5 of odd frames, each granted on the PDCCH by an SI-RNTI
DCI 1A or 1C; SI messages n >= 2 of ``si_schedule`` go in their 36.331
§5.2.3 SI windows under a DCI 1A; with ``paging_tmsi`` a P-RNTI DCI 1C and
a Paging message go in subframe 9.  Two and four ports send the control
channels and the PDSCH with SFBC and SFBC-FSTD.  Normal or extended CP.

:func:`capture` adds what a receiver sees: a start SFN and a start-sample
offset (the capture begins mid-transmission), a carrier frequency offset,
AWGN (``lteax.sim.channel.awgn``) at a per-resource-element SNR, and an
SDR sample rate reached through the port's polyphase resampler.

The IQ models one RX antenna with unit channels from every TX port, as
the reference's generator does.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

import numpy as np
import torch

from lteax_torch.kernels.polyphase import resample_poly
from lteax_torch.phy import seq
from lteax_torch.phy.channels import pbch, pcfich, pdcch, pdsch
from lteax_torch.phy.channels.dci import (TBS_1C, Dci1A, Dci1C, _n_rb_step,
                                          dci_1a_pack, dci_1c_pack)
from lteax_torch.phy.chest import precode_sfbc, precode_sfbc_fstd
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import (crs_flat_idx, crs_symbols, pbch_flat_idx,
                                  pcfich_flat_idx, pdcch_flat_idx,
                                  pdsch_flat_idx, pss_sym, sss_sym, sync_sc)
from lteax_torch.phy.ofdm import subframe_to_samples
from lteax_torch.phy.tables.tbs import tbs_1a
from lteax_torch.pipeline import _resolve_device
from lteax_torch.sim.channel import awgn
from lteax_torch.stack import rrc

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE


@dataclasses.dataclass(frozen=True)
class Cell:
    """A cell and its broadcast content, with ``file_gen.GenConfig``'s
    fields and defaults (``phich_duration_extended`` is the MIB's, False in
    ``file_gen``)."""
    n_rb_dl: int = 6
    n_cell_id: int = 0
    n_ant: int = 1
    phich_resource: float = 1.0
    phich_duration_extended: bool = False
    cfi: int = 2
    si_dci: str = "1a"          # "1a" | "1c": the DCI format of SI grants
    paging_tmsi: tuple[int, ...] = ()   # S-TMSIs paged in subframe 9
    tac: int = 0x1234
    extended_cp: bool = False
    mcc: tuple[int, int, int] = (0, 0, 1)
    mnc: tuple[int, ...] = (0, 1)
    cell_identity: int = 0x0050800
    band: int = 1
    sib1_mcs: int = 4           # I_TBS of the 1A grants, raised until SI fits
    extra_sibs: tuple = ()      # Sib3..Sib13 bodies carried in SI messages
    # ((periodicity_rf, (sib_types...)), ...): entry 0 is SI message 1
    # (SIB2 prepended, 36.331 §5.2.3), entries n >= 2 go in their own SI
    # windows; () sends SIB2 and every extra SIB in SI message 1
    si_schedule: tuple = ()

    @property
    def cfg(self) -> PhyConfig:
        return PhyConfig(n_rb_dl=self.n_rb_dl, n_ant=self.n_ant,
                         extended_cp=self.extended_cp)

    @property
    def ctrl_syms(self) -> int:
        return self.cfi + 1 if self.n_rb_dl <= 10 else self.cfi

    def mib(self, sfn: int) -> rrc.Mib:
        return rrc.Mib(n_rb_dl=self.n_rb_dl,
                       phich_duration_extended=self.phich_duration_extended,
                       phich_resource=self.phich_resource, sfn=sfn)

    def scheduling(self) -> tuple[rrc.SchedulingInfo, ...]:
        """SIB1's schedulingInfoList: ``si_schedule``'s entries, or one
        entry advertising every extra SIB type (SIB3 when there is none)."""
        if self.si_schedule:
            return tuple(rrc.SchedulingInfo(p, tuple(ts))
                         for p, ts in self.si_schedule)
        types = tuple(sorted({_sib_type(s) for s in self.extra_sibs}))
        return (rrc.SchedulingInfo(8, types or (3,)),)

    def sib1(self) -> rrc.Sib1:
        return rrc.Sib1(mcc=self.mcc, mnc=self.mnc, tac=self.tac,
                        cell_identity=self.cell_identity,
                        freq_band_indicator=self.band,
                        scheduling=self.scheduling())

    def sib2(self) -> rrc.Sib2:
        return rrc.Sib2()

    def si_messages(self) -> list[tuple]:
        """The SIB bodies of each SI message, SI message 1 first."""
        if not self.si_schedule:
            return [(self.sib2(), *self.extra_sibs)]
        bodies = {_sib_type(s): s for s in self.extra_sibs}
        return [((self.sib2(),) if j == 0 else ())
                + tuple(bodies[t] for t in ts)
                for j, (_, ts) in enumerate(self.si_schedule)]


def _sib_type(s) -> int:
    """The SIB number of a body: 3..11, or 12 / 13 (Rel-9 extensions)."""
    if type(s) in rrc.SIB_EXT_TYPE_INDEX:
        return rrc.SIB_EXT_TYPE_INDEX[type(s)] + 12
    return rrc.SIB_TYPE_INDEX[type(s)] + 2


@dataclasses.dataclass(frozen=True)
class SiBits:
    """The broadcast messages of a cell as sent: SIB1, the SI messages
    (``si[0]``, the one with SIB2, is also ``sib2``), the Paging message
    (or None), the 1A grants' I_TBS and the SI window in ms."""
    sib1: np.ndarray
    si: tuple[np.ndarray, ...]
    paging: np.ndarray | None
    mcs: int
    periodicities: tuple[int, ...] = (8,)   # each SI message's, in frames
    window_ms: int = 20

    @property
    def sib2(self) -> np.ndarray:
        return self.si[0]

    def extra_at(self, sfn: int, sf: int) -> np.ndarray | None:
        """The SI message n >= 2 sent in (sfn, sf), else None (36.331
        §5.2.3: window x = (n-1) w starts in the frame with SFN mod T =
        floor(x/10), sent in its first subframe other than 0, 5 and 9)."""
        for j in range(1, len(self.si)):
            t, x = self.periodicities[j], j * self.window_ms
            sf_tx = x % 10
            while sf_tx in (0, 5, 9):
                sf_tx = (sf_tx + 1) % 10
            if sfn % t == (x // 10) % t and sf == sf_tx:
                return self.si[j]
        return None


def si_bits(cell: Cell) -> SiBits:
    """Pack ``cell``'s SIB1, SI messages and Paging; raise the 1A grants'
    I_TBS from ``sib1_mcs`` until every message fits the N_PRB_1A = 2 TBS
    (as ``generate`` of the reference does)."""
    sib1 = cell.sib1()
    sib1_bits = rrc.pack_sib1(sib1)
    si = tuple(rrc.pack_si(*m) for m in cell.si_messages())
    paging = (rrc.pack_paging(rrc.Paging(ue_identities=cell.paging_tmsi))
              if cell.paging_tmsi else None)
    mcs = cell.sib1_mcs
    while tbs_1a(mcs, 2) < max(len(sib1_bits), *(len(m) for m in si)):
        mcs += 1
    return SiBits(sib1_bits, si, paging, mcs,
                  tuple(e.si_periodicity_rf for e in sib1.scheduling),
                  sib1.si_window_ms)


def build_subframe_grid(cell: Cell, sfn: int, sf: int,
                        pbch_quarters: np.ndarray,
                        si: SiBits | None = None,
                        extra_si: np.ndarray | None = None) -> np.ndarray:
    """One subframe's (n_sym, n_sc) complex64 grid, ports superposed:
    CRS of every port, PSS/SSS (port 0) in subframes 0 and 5, and the PBCH
    quarter ``sfn % 4`` in subframe 0; with ``si``, the PCFICH in every
    subframe, the SI grant and PDSCH in subframe 5, the paging grant and
    PDSCH in subframe 9 when there is a Paging message, and the SI message
    ``extra_si`` (``si.extra_at(sfn, sf)``) under a DCI 1A."""
    cfg, cid, n_ant = cell.cfg, cell.n_cell_id, cell.n_ant
    ports = np.zeros((n_ant, cfg.n_sym_subframe * cfg.n_sc), np.complex64)

    def sfbc_scatter(idx: np.ndarray, syms: np.ndarray):
        x = torch.from_numpy(np.asarray(syms, np.complex64))
        per_port = ((x,) if n_ant == 1 else precode_sfbc(x) if n_ant == 2
                    else precode_sfbc_fstd(x))
        for p, v in enumerate(per_port):
            ports[p][idx] = v.numpy()

    def grant(dci_bits: np.ndarray, rnti: int, prbs: tuple[int, ...],
              tbs: int, rv: int, msg: np.ndarray):
        """A DCI on CCEs 0-3 and its transport block on ``prbs``."""
        ctrl, ng = cell.ctrl_syms, cell.phich_resource
        pd_syms = pdcch.pdcch_encode([(dci_bits, rnti, 0, 4)], cfg, cid,
                                     ctrl, ng, sf, n_ant=n_ant)
        pd_idx = pdcch_flat_idx(cfg, cid, ctrl, ng).reshape(-1)
        for p in range(pd_syms.shape[0]):
            ports[p][pd_idx] = pd_syms[p]
        re_idx = pdsch_flat_idx(cfg, cid, ctrl, prbs, sf)
        geom = pdsch.pdsch_geometry(tbs, len(re_idx), 2, rv)
        sfbc_scatter(re_idx, pdsch.pdsch_encode(rrc.pad_to(msg, tbs), geom,
                                                rnti, sf, cid, "qpsk"))

    def grant_1a(rv: int, msg: np.ndarray):
        """An SI message under a DCI 1A on the first min(n_rb, 6) PRBs."""
        l_crb = min(cfg.n_rb_dl, 6)
        grant(dci_1a_pack(Dci1A(rb_start=0, l_crb=l_crb, mcs=si.mcs, rv=rv,
                                tpc=0), cfg.n_rb_dl),
              SI_RNTI, tuple(range(l_crb)), tbs_1a(si.mcs, 2), rv, msg)

    for p in range(n_ant):
        vals = [seq.crs_values(cid, 2 * sf + sym // cfg.n_sym_slot,
                               sym % cfg.n_sym_slot, cfg.n_rb_dl,
                               cfg.extended_cp)
                for sym in crs_symbols(p, cfg)]
        ports[p][crs_flat_idx(cfg, cid, p)] = np.concatenate(vals)
    if sf in (0, 5):
        scs = sync_sc(cfg)
        ports[0][pss_sym(cfg) * cfg.n_sc + scs] = seq.pss_sequence(cid % 3)
        ports[0][sss_sym(cfg) * cfg.n_sc + scs] = seq.sss_sequence(
            cid // 3, cid % 3, sf == 5)
    if sf == 0:
        per_port = pbch.pbch_quarter_to_grid(pbch_quarters[sfn % 4], cfg,
                                             cid, n_ant)
        for p in range(n_ant):
            ports[p][pbch_flat_idx(cfg, cid)] = per_port[p]
    if si is not None:
        sfbc_scatter(pcfich_flat_idx(cfg, cid),
                     pcfich.pcfich_encode(cell.cfi, cid, sf))
        step = _n_rb_step(cfg.n_rb_dl)
        ndl = cfg.n_rb_dl // step
        if sf == 5:
            msg = si.sib1 if sfn % 2 == 0 else si.sib2
            # 36.321 §5.3.1: RV_K = ceil(3/2 k) mod 4, k = (SFN / 2) mod 4
            rv = int(np.ceil(1.5 * ((sfn // 2) % 4))) % 4 \
                if sfn % 2 == 0 else 0
            if cell.si_dci == "1c":
                i_tbs = next(i for i, t in enumerate(TBS_1C)
                             if t >= max(len(si.sib1), len(si.sib2)))
                grant(dci_1c_pack(Dci1C(rb_start=0, l_crb=ndl, i_tbs=i_tbs),
                                  cfg.n_rb_dl), SI_RNTI,
                      tuple(range(ndl * step)), TBS_1C[i_tbs], rv, msg)
            else:
                grant_1a(rv, msg)
        if extra_si is not None:
            grant_1a(0, extra_si)
        if sf == 9 and si.paging is not None:
            i_tbs = next(i for i, t in enumerate(TBS_1C)
                         if t >= len(si.paging))
            grant(dci_1c_pack(Dci1C(rb_start=0, l_crb=ndl, i_tbs=i_tbs),
                              cfg.n_rb_dl), P_RNTI, tuple(range(ndl * step)),
                  TBS_1C[i_tbs], 0, si.paging)
    return ports.sum(axis=0).reshape(cfg.n_sym_subframe, cfg.n_sc)


def generate(cell: Cell, n_subframes: int, sfn0: int = 0,
             device=None) -> np.ndarray:
    """-> (n_subframes * n_samps_subframe,) complex64 baseband starting at
    subframe 0 of frame ``sfn0``, broadcasting ``cell``'s SI.  The grids
    are built on the host and OFDM-modulated on ``device`` (default: the
    current CUDA device; without one this raises unless ``device="cpu"``)."""
    device = _resolve_device(device)
    cfg = cell.cfg
    si = si_bits(cell)
    grids, quarters = [], {}
    for i in range(n_subframes):
        sfn = (sfn0 + i // 10) % 1024
        if sfn // 4 not in quarters:
            quarters[sfn // 4] = pbch.pbch_encode_40ms(
                rrc.pack_mib(cell.mib(sfn)), cell.n_ant, cell.n_cell_id,
                cfg.extended_cp)
        grids.append(build_subframe_grid(cell, sfn, i % 10,
                                         quarters[sfn // 4], si,
                                         si.extra_at(sfn, i % 10)))
    x = subframe_to_samples(torch.from_numpy(np.stack(grids)).to(device),
                            cfg)
    return x.reshape(-1).cpu().numpy()


@dataclasses.dataclass(frozen=True)
class Capture:
    """What a scan of the capture should report."""
    iq: np.ndarray              # (n,) complex64 at ``rate_hz``
    rate_hz: float
    n_cell_id: int
    n_ant: int
    sfn: int                    # SFN of the first whole frame in the capture
    cfo_hz: float
    snr_db: float


def capture(cell: Cell, duration_s: float, *, sfn0: int = 0,
            offset: int = 0, cfo_hz: float = 0.0,
            snr_db: float | None = None, rate_hz: float | None = None,
            seed: int = 0, device=None) -> Capture:
    """A capture of ``duration_s`` seconds that starts ``offset`` native
    samples after the start of frame ``sfn0`` (0 <= offset < one frame),
    generated on ``device`` as :func:`generate` (the card unless the
    caller passes ``device="cpu"``).

    Impairments, in order: CFO, then AWGN at ``snr_db`` per resource
    element (unit-power REs, orthonormal OFDM), then resampling to
    ``rate_hz`` (default: native) by the port's polyphase resampler on
    ``device`` (the resampler kernel on the card); the capture comes home
    once, at the end."""
    device = _resolve_device(device)
    cfg = cell.cfg
    nsf = cfg.n_samps_subframe
    n_native = int(math.ceil(duration_s * cfg.fs))
    n_sf = -(-(offset + n_native) // nsf) + 2    # + resampler margin
    x = generate(cell, n_sf, sfn0, device)[offset:offset + n_native
                                           + 2 * nsf]
    if cfo_hz:
        n = np.arange(len(x))
        x = (x * np.exp(2j * np.pi * cfo_hz * n / cfg.fs)).astype(np.complex64)
    if snr_db is not None:
        # awgn() sets the noise against the mean sample power; shift its
        # SNR so that the noise variance per sample is 10^(-snr/10)
        p = float(np.mean(np.abs(x) ** 2))
        x = awgn(np.random.default_rng(seed), x, snr_db + 10 * np.log10(p))
    rate = float(cfg.fs) if rate_hz is None else float(rate_hz)
    if abs(rate - cfg.fs) > 1.0:
        frac = Fraction(int(round(rate)), int(round(cfg.fs))) \
            .limit_denominator(1024)
        x = resample_poly(torch.from_numpy(x).to(device), frac.numerator,
                          frac.denominator).cpu().numpy()
    n_out = int(math.ceil(duration_s * rate))
    return Capture(iq=np.ascontiguousarray(x[:n_out]), rate_hz=rate,
                   n_cell_id=cell.n_cell_id, n_ant=cell.n_ant,
                   sfn=(sfn0 + (1 if offset > 0 else 0)) % 1024,
                   cfo_hz=cfo_hz, snr_db=np.nan if snr_db is None else snr_db)
