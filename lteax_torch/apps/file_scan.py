"""Capture scanner: cell search, MIB and SI decode from an IQ capture;
counterpart of ``lteax.apps.file_scan``.

:func:`scan` runs the reference's whole-capture batched stages on the
capture's device: coarse CFO -> PSS -> SSS -> batched OFDM demod of every
whole subframe -> PBCH blind decode over n_ant in {1, 2, 4} with RSRP, SNR
and EVM -> SI decode over the SI subframes (per subframe: CRS channel
estimate of the cell's ports, PCFICH, PDCCH blind decode of an SI-RNTI
DCI 1A or 1C, the SI PDSCH through ``pdsch.pdsch_decode_llrs``, then
SIB1 / SystemInformation) and paging in subframe 9 (a P-RNTI DCI 1C and
its Paging message).  ``max_si_subframes=0`` stops at the MIB.

Host reads: the stages branch on host integers, so each reads one small
tensor — the CFO, the PSS (root and index), the SSS (N_id_1 and half) and
the PBCH decode, which brings the 12 hypotheses' CRC flags and bits, the
RSRP / noise estimates and the EVMs home in one read: 4 per capture to the
MIB.  The SI stage reads once per decision: the CFI, each blind decode
(1A, then 1C if 1A found nothing) and each transport block.
``lteax_torch.host.READS`` counts them.

    python -m lteax_torch.apps.file_scan PATH [--n-rb 6] [--fmt fc32|sc8]
        [--no-cfo] [--extended-cp] [--device cuda|cpu]

prints the report (``ScanResult.to_json``) of a capture file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import numpy as np
import torch

from lteax_torch.host import read
from lteax_torch.io.iq import read_iq
from lteax_torch.phy import chest, sync
from lteax_torch.phy.channels import pbch, pcfich, pdcch, pdsch
from lteax_torch.phy.channels.dci import _n_rb_step
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.fec.crc import exact_f32_matmul
from lteax_torch.phy.grid import (crs_flat_idx, pbch_flat_idx, pcfich_flat_idx,
                                  pdcch_flat_idx, pdsch_flat_idx, pss_sym,
                                  sss_sym, sync_sc)
from lteax_torch.phy.mod import demodulate_maxlog
from lteax_torch.phy.ofdm import samples_to_subframe
from lteax_torch.phy.tuning import OFDM_DFTS
from lteax_torch.phy.tables.tbs import tbs_1a
from lteax_torch.pipeline import _resolve_device
from lteax_torch.stack import rrc

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE


@dataclasses.dataclass
class ScanResult:
    n_cell_id: int = -1
    n_id_1: int = -1
    n_id_2: int = -1
    cfo_hz: float = 0.0
    frame_start: int = -1
    rsrp_dbfs: float = 0.0      # CRS RE power, dB full-scale
    snr_db: float = 0.0         # CRS-based post-FFT SNR estimate
    evm_pct: float = 0.0        # PBCH equalized-symbol EVM (%)
    mib: rrc.Mib | None = None
    n_ant: int = 0
    sfn: int = -1
    sib1: rrc.Sib1 | None = None
    sib2: rrc.Sib2 | None = None
    sibs: dict = dataclasses.field(default_factory=dict)  # sib3..sib13 bodies
    sib_crc_fails: int = 0
    paging: list | None = None
    # per successful SI PDSCH decode: dict(sf_index [into the frame_start-
    # aligned subframe stream], sf, ctrl, prbs, tbs, rv, tb bits); not
    # serialized in to_json
    si_decodes: list = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        d = {
            "n_cell_id": self.n_cell_id,
            "n_id_1": self.n_id_1,
            "n_id_2": self.n_id_2,
            "cfo_hz": round(self.cfo_hz, 1),
            "frame_start": self.frame_start,
            "rsrp_dbfs": round(self.rsrp_dbfs, 1),
            "snr_db": round(self.snr_db, 1),
            "evm_pct": round(self.evm_pct, 2),
            "sfn": self.sfn,
            "n_ant": self.n_ant,
            "mib": dataclasses.asdict(self.mib) if self.mib else None,
            "sib1": dataclasses.asdict(self.sib1) if self.sib1 else None,
            "sib2": dataclasses.asdict(self.sib2) if self.sib2 else None,
            "sibs": {k: dataclasses.asdict(v) for k, v in self.sibs.items()},
            "sib_crc_fails": self.sib_crc_fails,
            "paging": self.paging,
        }
        return json.dumps(d, default=lambda o: o.hex()
                          if isinstance(o, bytes) else str(o))


def _ctrl_syms(cfi: int, n_rb: int) -> int:
    return cfi + 1 if n_rb <= 10 else cfi


def _idx(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=dev)


def _evm_pct(x: torch.Tensor) -> torch.Tensor:
    """EVM (%) of equalised QPSK symbols against their hard decisions."""
    hard = torch.complex(torch.sign(x.real), torch.sign(x.imag)) / math.sqrt(2)
    err = torch.mean(torch.abs(x - hard) ** 2)
    ref = torch.clamp_min(torch.mean(torch.abs(hard) ** 2), 1e-12)
    return 100.0 * torch.sqrt(err / ref)


def scan(x, cfg: PhyConfig, correct_cfo: bool = True,
         cfi_hint: int | None = None, ng: float = 1.0,
         max_si_subframes: int = 64, device=None,
         dft: str = "fft") -> ScanResult:
    """Cell search, MIB and SI of a capture x (L,) complex: a torch tensor
    (the scan runs on its device, or on ``device`` when one is named) or a
    numpy array, which goes to ``device``: by default the current CUDA
    device (without one the call raises unless ``device="cpu"``).

    The SI stage looks at the first ``max_si_subframes`` subframes (0:
    none); ``cfi_hint`` skips the PCFICH decode.  ``ng`` is unused, as in
    the reference: the PHICH resource comes from the MIB.  ``dft`` is the
    OFDM demod's DFT (``phy.ofdm.samples_to_subframe``; the reference's
    default is "factored")."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x)).to(_resolve_device(device))
    elif device is not None:
        x = x.to(device)
    exact_f32_matmul()
    res = ScanResult()
    xt = x.to(torch.complex64)
    dev = xt.device
    nsf = cfg.n_samps_subframe

    # 1. coarse CFO
    if correct_cfo and xt.shape[-1] >= 3 * nsf:
        _, cfo = sync.coarse_timing_and_cfo(xt, cfg)
        res.cfo_hz = read(cfo)
        xt = sync.apply_cfo(xt, cfo, cfg.fs)

    # 2. PSS
    nid2, pss_idx, _ = sync.find_pss(xt, cfg)
    n_id_2, pss_idx = read(torch.stack([nid2, pss_idx]))
    sf_start = pss_idx - cfg.symbol_starts_subframe[pss_sym(cfg)]
    if sf_start < 0:
        sf_start += 5 * nsf                  # use the next PSS occurrence
    res.n_id_2 = n_id_2

    # 3. SSS — demod the PSS-bearing subframe
    sf_grid = samples_to_subframe(xt[sf_start:sf_start + nsf], cfg, dft)
    scs = torch.as_tensor(sync_sc(cfg).astype(np.int64), device=dev)
    nid1, half5, _ = sync.sss_detect(sf_grid[sss_sym(cfg), scs],
                                     sf_grid[pss_sym(cfg), scs], n_id_2)
    n_id_1, half5 = read(torch.stack([nid1, half5.long()]))
    res.n_id_1 = n_id_1
    res.n_cell_id = cid = 3 * n_id_1 + n_id_2
    frame_start = sf_start - (5 if half5 else 0) * nsf
    if frame_start < 0:
        frame_start += 10 * nsf
    res.frame_start = frame_start

    # 4. batch-demodulate all whole subframes from frame_start
    n_sf = (xt.shape[-1] - frame_start) // nsf
    if n_sf < 1:
        return res
    sfs = xt[frame_start:frame_start + n_sf * nsf].reshape(n_sf, nsf)
    grids = samples_to_subframe(sfs, cfg, dft)       # (n_sf, 14, n_sc)

    # 5. MIB from the first subframe 0, blind over n_ant
    g0 = grids[0]
    h = [chest.estimate_channel(g0, cfg, cid, 0, port=p).reshape(-1)
         for p in range(4)]
    nv0 = chest.estimate_noise_var(g0, cfg, cid, 0)
    crs_idx = torch.as_tensor(crs_flat_idx(cfg, cid, 0).astype(np.int64),
                              device=dev)
    crs_p = torch.mean(torch.abs(g0.reshape(-1)[crs_idx]) ** 2)
    pb_idx = torch.as_tensor(pbch_flat_idx(cfg, cid).astype(np.int64),
                             device=dev)
    y_pb = g0.reshape(-1)[pb_idx]
    hp = [hh[pb_idx] for hh in h]
    eq = {ant: chest.equalize_res(y_pb, hp[0], hp[1], nv0, ant)
          for ant in (1, 2)}
    eq[4] = chest.combine_sfbc_fstd(y_pb, *hp, nv0)
    llrs = {ant: demodulate_maxlog(xe, "qpsk", eff)
            for ant, (xe, eff) in eq.items()}
    extra = torch.stack([crs_p, nv0, *(_evm_pct(eq[a][0]) for a in (1, 2, 4))])
    mib_bits, n_ant, quarter, ok, (crs_p, nv0, *evms) = \
        pbch.pbch_blind_decode(llrs, cid, extended_cp=cfg.extended_cp,
                               extra=extra)
    res.rsrp_dbfs = 10 * float(np.log10(max(crs_p, 1e-12)))
    res.snr_db = 10 * float(np.log10(max(crs_p / max(nv0, 1e-12) - 1.0,
                                         1e-3)))
    if not ok:
        return res
    res.evm_pct = evms[(1, 2, 4).index(n_ant)]
    res.n_ant = n_ant
    res.mib = rrc.unpack_mib(mib_bits, sfn_mod4=quarter)
    res.sfn = res.mib.sfn
    mib = res.mib
    if mib.n_rb_dl != cfg.n_rb_dl:
        # capture decoded at a different bandwidth than the cell's: report
        # the MIB
        return res

    # 6. SI decode over the SI subframes (n_ant-aware: SISO, SFBC or
    #    SFBC-FSTD combining)
    ng = mib.phich_resource
    cfg_c = PhyConfig(n_rb_dl=cfg.n_rb_dl, n_ant=n_ant,
                      extended_cp=cfg.extended_cp)
    si_done: set[int] = set()

    def _win_entry(sfn: int, sf: int):
        """Pending n>=2 SI-window entry covering (sfn, sf), else None
        (36.331 §5.2.3: window x=(n-1)*w from frame SFN % T == x//10)."""
        if res.sib1 is None or sf in (0, 5, 9):
            return None
        w = res.sib1.si_window_ms
        for j in range(1, len(res.sib1.scheduling)):
            if j in si_done:
                continue
            t = res.sib1.scheduling[j].si_periodicity_rf
            x = j * w
            rel = (((sfn % t) - (x // 10) % t) * 10 + sf - x % 10) % (t * 10)
            if 0 <= rel < w:
                return j
        return None

    def _all_si_done() -> bool:
        return (res.sib1 is not None
                and len(si_done) >= len(res.sib1.scheduling) - 1)

    for i in range(n_sf):
        sf = i % 10
        sfn = mib.sfn + i // 10
        if sf == 9 and res.paging is None and i < max_si_subframes:
            _try_paging(res, grids[i], cfg, cfg_c, cid, sf, ng)
        win_j = _win_entry(sfn, sf) if sf != 5 else None
        if (sf != 5 and win_j is None) or res.sib_crc_fails > 8:
            continue
        if res.sib1 is not None and res.sib2 is not None and _all_si_done():
            break
        if i >= max_si_subframes:
            break
        sub = _Subframe(grids[i], cfg, cfg_c, cid, sf, n_ant)
        cfi = (read(sub.cfi_decode()) if cfi_hint is None else cfi_hint)
        ctrl = _ctrl_syms(cfi, cfg.n_rb_dl)
        logical, n_cces = sub.pdcch_logical(ctrl, ng)
        found = pdcch.pdcch_blind_decode_1a(logical, cfg.n_rb_dl, SI_RNTI,
                                            n_cces)
        if found:
            dci, _, _ = found[0]
            prbs = tuple(range(dci.rb_start, dci.rb_start + dci.l_crb))
            tbs = tbs_1a(dci.mcs, dci.n_prb_1a)
            rv = dci.rv
        else:
            found_1c = pdcch.pdcch_blind_decode_1c(logical, cfg.n_rb_dl,
                                                   SI_RNTI, n_cces)
            if not found_1c:
                continue
            dci, _, _ = found_1c[0]
            step = _n_rb_step(cfg.n_rb_dl)
            prbs = tuple(range(dci.rb_start * step,
                               (dci.rb_start + dci.l_crb) * step))
            tbs = dci.tbs()
            # 1C carries no RV: SI uses the 36.321 SFN-derived RV
            rv = int(np.ceil(1.5 * ((sfn // 2) % 4))) % 4 \
                if sfn % 2 == 0 else 0
        re_idx = pdsch_flat_idx(cfg_c, cid, ctrl, prbs, sf)
        geom = pdsch.pdsch_geometry(tbs, len(re_idx), 2, rv)
        tb, okc, _ = pdsch.pdsch_decode_llrs(sub.llrs(re_idx), geom, SI_RNTI,
                                             sf, cid)
        if not okc:
            res.sib_crc_fails += 1
            continue
        res.si_decodes.append(dict(sf_index=i, sf=sf, ctrl=ctrl, prbs=prbs,
                                   tbs=tbs, rv=rv, tb=tb))
        sib1 = rrc.unpack_sib1(tb)
        if sib1 is not None and res.sib1 is None:
            res.sib1 = sib1
            continue
        for name, body in rrc.unpack_si_list(tb):
            if name == "sib2":
                res.sib2 = body
            elif name not in res.sibs:
                res.sibs[name] = body
        if win_j is not None:
            si_done.add(win_j)
    return res


class _Subframe:
    """One subframe's grid with the channel estimates of its first
    ``n_ant`` ports and its noise estimate: equalised (SISO, SFBC or
    SFBC-FSTD) QPSK LLRs of any RE set."""

    def __init__(self, g: torch.Tensor, cfg: PhyConfig, cfg_c: PhyConfig,
                 cid: int, sf: int, n_ant: int):
        self.cfg_c, self.cid, self.sf, self.n_ant = cfg_c, cid, sf, n_ant
        self.dev = g.device
        self.gflat = g.reshape(-1)
        self.h = [chest.estimate_channel(g, cfg, cid, sf, port=p).reshape(-1)
                  for p in range(n_ant)]
        self.nv = chest.estimate_noise_var(g, cfg, cid, sf)

    def _equalize(self, y, h):
        if self.n_ant == 4:
            return chest.combine_sfbc_fstd(y, *h, self.nv)
        return chest.equalize_res(y, h[0], h[-1], self.nv, self.n_ant)

    def llrs(self, idx: np.ndarray) -> torch.Tensor:
        """QPSK LLRs of the REs ``idx`` (channel-mapping order)."""
        t = _idx(idx, self.dev)
        x_eq, eff = self._equalize(self.gflat[t], [hh[t] for hh in self.h])
        return demodulate_maxlog(x_eq, "qpsk", eff)

    def cfi_decode(self) -> torch.Tensor:
        """The PCFICH's CFI, on the device."""
        return pcfich.pcfich_decode(
            self.llrs(pcfich_flat_idx(self.cfg_c, self.cid)), self.cid,
            self.sf)[0]

    def pdcch_logical(self, ctrl: int, ng: float):
        """-> (descrambled PDCCH LLRs in logical CCE order, n_cce): the
        symbols are de-interleaved before they are equalised (SFBC pairs
        live in logical order)."""
        cfg_c, cid = self.cfg_c, self.cid
        pd_idx = _idx(pdcch_flat_idx(cfg_c, cid, ctrl, ng).reshape(-1),
                      self.dev)
        logical = lambda v: pdcch.unpermute_to_logical(v[pd_idx], cfg_c, cid,
                                                       ctrl, ng)
        x_eq, eff = self._equalize(logical(self.gflat),
                                   [logical(hh) for hh in self.h])
        llr = pdcch.pdcch_descramble_logical(
            demodulate_maxlog(x_eq, "qpsk", eff), cfg_c, cid, ctrl, ng,
            self.sf)
        return llr, pdcch.n_cce(cfg_c, cid, ctrl, ng)


def _try_paging(res: ScanResult, g: torch.Tensor, cfg: PhyConfig,
                cfg_c: PhyConfig, cid: int, sf: int, ng: float) -> None:
    """Blind-decode a P-RNTI DCI 1C in subframe 9 and parse Paging.  As in
    the reference, the receiver is SISO on port 0's estimate whatever the
    cell's port count."""
    sub = _Subframe(g, cfg, cfg_c, cid, sf, n_ant=1)
    ctrl = _ctrl_syms(read(sub.cfi_decode()), cfg.n_rb_dl)
    logical, n_cces = sub.pdcch_logical(ctrl, ng)
    found = pdcch.pdcch_blind_decode_1c(logical, cfg.n_rb_dl, P_RNTI, n_cces)
    if not found:
        return
    dci, _, _ = found[0]
    step = _n_rb_step(cfg.n_rb_dl)
    prbs = tuple(range(dci.rb_start * step, (dci.rb_start + dci.l_crb) * step))
    re_idx = pdsch_flat_idx(cfg_c, cid, ctrl, prbs, sf)
    geom = pdsch.pdsch_geometry(dci.tbs(), len(re_idx), 2, 0)
    tb, okc, _ = pdsch.pdsch_decode_llrs(sub.llrs(re_idx), geom, P_RNTI, sf,
                                         cid)
    if okc:
        pg = rrc.unpack_paging(tb)
        if pg is not None:
            res.paging = [hex(t) for t in pg.ue_identities]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="LTE DL IQ file scanner")
    p.add_argument("path")
    p.add_argument("--n-rb", type=int, default=6,
                   help="bandwidth of the capture (sets sample rate)")
    p.add_argument("--fmt", choices=("fc32", "sc8"), default="fc32")
    p.add_argument("--no-cfo", action="store_true")
    p.add_argument("--extended-cp", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    p.add_argument("--ofdm-dft", default="fft", choices=OFDM_DFTS,
                   help="the OFDM demod's DFT")
    a = p.parse_args(argv)
    cfg = PhyConfig(n_rb_dl=a.n_rb, extended_cp=a.extended_cp)
    res = scan(read_iq(a.path, a.fmt), cfg, correct_cfo=not a.no_cfo,
               device=a.device, dft=a.ofdm_dft)
    print(res.to_json())


if __name__ == "__main__":
    main()
