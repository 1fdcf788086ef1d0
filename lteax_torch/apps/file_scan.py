"""Capture scanner: cell search and MIB from an IQ capture; counterpart of
``lteax.apps.file_scan`` up to the MIB.

:func:`scan` runs the reference's whole-capture batched stages 1-5 on the
capture's device: coarse CFO -> PSS -> SSS -> batched OFDM demod of every
whole subframe -> PBCH blind decode over n_ant in {1, 2, 4} with RSRP, SNR
and EVM.  Stage 6 (SI decode: PCFICH, PDCCH, DCI, SI PDSCH) is not ported
yet; ``max_si_subframes=0`` asks for the MIB-level result, which is what
the reference's ``scan(..., max_si_subframes=0)`` returns.

Host reads: the stages branch on host integers, so each reads one small
tensor — the CFO, the PSS (root and index), the SSS (N_id_1 and half) and
the PBCH decode, which brings the 12 hypotheses' CRC flags and bits, the
RSRP / noise estimates and the EVMs home in one read: 4 per capture.
``lteax_torch.host.READS`` counts them.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from lteax_torch.host import read
from lteax_torch.phy import chest, sync
from lteax_torch.phy.channels import pbch
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.fec.crc import exact_f32_matmul
from lteax_torch.phy.grid import (crs_flat_idx, pbch_flat_idx, pss_sym, sss_sym,
                                  sync_sc)
from lteax_torch.phy.mod import demodulate_maxlog
from lteax_torch.phy.ofdm import samples_to_subframe
from lteax_torch.stack import rrc

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
    sib1: object | None = None   # SI decode is not ported: stays None
    sib2: object | None = None
    sibs: dict = dataclasses.field(default_factory=dict)
    sib_crc_fails: int = 0
    paging: list | None = None
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


def _evm_pct(x: torch.Tensor) -> torch.Tensor:
    """EVM (%) of equalised QPSK symbols against their hard decisions."""
    hard = torch.complex(torch.sign(x.real), torch.sign(x.imag)) / math.sqrt(2)
    err = torch.mean(torch.abs(x - hard) ** 2)
    ref = torch.clamp_min(torch.mean(torch.abs(hard) ** 2), 1e-12)
    return 100.0 * torch.sqrt(err / ref)


def scan(x, cfg: PhyConfig, correct_cfo: bool = True,
         cfi_hint: int | None = None, ng: float = 1.0,
         max_si_subframes: int = 64) -> ScanResult:
    """Cell search + MIB of a capture x (L,) complex: a torch tensor (the
    scan runs on its device) or a numpy array (scanned on the CPU).

    Only ``max_si_subframes=0`` is supported: the SI stage is not ported.
    ``cfi_hint`` and ``ng`` are the SI stage's and unused here."""
    if max_si_subframes > 0:
        raise NotImplementedError("SI decode (PCFICH/PDCCH/DCI) is not "
                                  "ported yet: pass max_si_subframes=0")
    exact_f32_matmul()
    res = ScanResult()
    xt = (x if isinstance(x, torch.Tensor)
          else torch.from_numpy(np.array(x))).to(torch.complex64)
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
    sf_grid = samples_to_subframe(xt[sf_start:sf_start + nsf], cfg)
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
    grids = samples_to_subframe(sfs, cfg)            # (n_sf, 14, n_sc)

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
    return res
