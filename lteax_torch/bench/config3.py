"""Milestone config #3 (``configs/config3_fading_10mhz.yaml``: 10 MHz,
``n_rb_dl`` 50, 2 antenna ports, the MMSE channel estimate, EPA/EVA
fading) as three gates, the ones ``tests/test_chest.py:29,42`` and
``tests/test_loopback.py:65`` hold the reference to, at the config's 50
PRB and on a chosen device:

1. :func:`noise_estimate` — the CRS noise estimate of one subframe under
   an EVA snapshot at 10 dB is within a factor 2 of the true noise;
2. :func:`chest_mse` — over 5 EVA snapshots at 10 dB, the Wiener (MMSE)
   estimate's mean squared error at symbol 5 is below the LS estimate's;
3. :func:`sfbc_loopback` — a noiseless 40 ms capture of a 2-port cell
   from ``sim/cell_gen.py`` scanned by ``apps/file_scan.scan``: the cell
   id, 2 ports, the MIB, SIB1 (its TAC) and SIB2, no SI CRC failure.

The chest gates use a subframe holding port 0's CRS only, as the
reference's do.  The reference has no module for config #3; these
functions are the port's, jax-free, for the CPU tests
(``tests/test_torch_config3.py``) and the card (``chip_smoke.py``'s
``[config3]`` phase).
"""

from __future__ import annotations

import numpy as np
import torch

from lteax_torch.apps.file_scan import scan
from lteax_torch.phy import chest
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.grid import crs_flat_idx
from lteax_torch.phy.ofdm import samples_to_subframe, subframe_to_samples
from lteax_torch.sim.cell_gen import Cell, capture
from lteax_torch.sim.channel import apply_multipath, tap_impulse_response
from lteax_torch.sim.dl_gen import crs_grid_values

N_RB = 50
CFG = PhyConfig(n_rb_dl=N_RB)
CID, SF = 77, 2
SNR_DB = 10.0
PROFILE = "eva"
LOOPBACK_CELL = Cell(n_rb_dl=N_RB, n_cell_id=33, n_ant=2, tac=0x77)


def crs_samples() -> np.ndarray:
    """One subframe holding port 0's CRS and nothing else, as time-domain
    samples (n_samps_subframe,) complex64."""
    grid = np.zeros((CFG.n_sym_subframe, CFG.n_sc), np.complex64)
    grid.reshape(-1)[crs_flat_idx(CFG, CID, 0)] = crs_grid_values(CFG, CID,
                                                                  SF)
    return subframe_to_samples(torch.from_numpy(grid), CFG).numpy()


def faded(rng: np.random.Generator, x: np.ndarray):
    """An EVA snapshot of ``x`` with AWGN at ``SNR_DB`` below its mean
    power -> (received samples, impulse response, noise variance)."""
    h = tap_impulse_response(rng, PROFILE, CFG.fs)
    y0 = apply_multipath(x, h)
    nv = float(np.mean(np.abs(y0) ** 2)) / 10 ** (SNR_DB / 10)
    n = rng.standard_normal(len(y0)) + 1j * rng.standard_normal(len(y0))
    return (y0 + n.astype(np.complex64) * np.sqrt(nv / 2)), h, nv


def received_grid(y: np.ndarray, device) -> torch.Tensor:
    return samples_to_subframe(
        torch.from_numpy(y.astype(np.complex64)).to(device), CFG)


def noise_estimate(device, seed: int = 1) -> dict:
    """Gate 1: -> {"nv_est", "nv_true", "ratio", "ok"} (ok: 0.5 < ratio
    < 2)."""
    rng = np.random.default_rng(seed)
    y, _, nv = faded(rng, crs_samples())
    est = float(chest.estimate_noise_var(received_grid(y, device), CFG, CID,
                                         SF))
    ratio = est / nv
    return {"nv_est": est, "nv_true": nv, "ratio": ratio,
            "ok": bool(0.5 < ratio < 2.0)}


def true_response(h: np.ndarray) -> np.ndarray:
    """The channel's frequency response on the grid's subcarriers."""
    imp = np.zeros(CFG.n_fft, np.complex64)
    imp[:len(h)] = h
    return np.fft.fft(imp)[CFG.sc_to_fft_bin]


def chest_mse(device, seed: int = 0, trials: int = 5) -> dict:
    """Gate 2: -> {"ls_mse", "mmse_mse", "ok"} (ok: MMSE below LS), the
    mean over ``trials`` snapshots of each estimate's MSE at symbol 5,
    the MMSE estimate with the noise estimate as its prior."""
    rng = np.random.default_rng(seed)
    x = crs_samples()
    ls_err, mmse_err = [], []
    for _ in range(trials):
        y, h, _ = faded(rng, x)
        back = received_grid(y, device)
        nv = float(chest.estimate_noise_var(back, CFG, CID, SF))
        h_ls = chest.estimate_channel(back, CFG, CID, SF, 0)[5].cpu().numpy()
        h_mmse = chest.estimate_channel_mmse(back, CFG, CID, SF, 0,
                                             nv)[5].cpu().numpy()
        h_true = true_response(h)
        ls_err.append(float(np.mean(np.abs(h_ls - h_true) ** 2)))
        mmse_err.append(float(np.mean(np.abs(h_mmse - h_true) ** 2)))
    ls, mmse = float(np.mean(ls_err)), float(np.mean(mmse_err))
    return {"ls_mse": ls, "mmse_mse": mmse, "ok": bool(mmse < ls)}


def sfbc_loopback(device) -> dict:
    """Gate 3: -> {"n_cell_id", "n_ant", "mib", "sib1_tac", "sib2",
    "sib_crc_fails", "ok"}."""
    cell = LOOPBACK_CELL
    cap = capture(cell, 0.04, device=device)
    r = scan(cap.iq, CFG, device=device)
    out = {"n_cell_id": r.n_cell_id, "n_ant": r.n_ant,
           "mib": r.mib is not None and r.mib.n_rb_dl == N_RB,
           "sib1_tac": None if r.sib1 is None else r.sib1.tac,
           "sib1": r.sib1 == cell.sib1(), "sib2": r.sib2 == cell.sib2(),
           "sib_crc_fails": r.sib_crc_fails}
    out["ok"] = bool(out["n_cell_id"] == cell.n_cell_id and out["n_ant"] == 2
                     and out["mib"] and out["sib1"] and out["sib2"]
                     and out["sib1_tac"] == cell.tac
                     and out["sib_crc_fails"] == 0)
    return out
