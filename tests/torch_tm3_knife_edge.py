"""How far the iteration count of the TM3 MMSE cell that
``tests/test_torch_bf16.py::test_tm3_mmse_decode_shipped_matches_reference_factored``
decodes (6 PRB, MCS 28, seed 9, 25 dB, B = 2) moves with the last bits of
its front, on the CPU.

Prints one line for each of:

- the reference's front at each OFDM DFT form, then its turbo stage;
- the port's front at each form, its decode, and the reference's turbo
  stage on the port's LLRs (bits and iteration count);
- the IQ scaled by ``1 + 1e-7 * N(0, 1)`` per sample (a change of about
  one f32 ulp), ``--draws`` times: the port's decode at each form, and
  for the first ``--ref-draws`` draws the reference's at the FFT.

Run from the repository root (a few minutes)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_tm3_knife_edge.py
"""

import argparse
import dataclasses
import os

import conftest  # noqa: F401  (JAX on the CPU)
import jax
import jax.numpy as jnp
import numpy as np
import torch

from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.config import PhyConfig as RefPhyConfig
from lteax.phy.tuning import DecoderTuning as RefTuning
from lteax.shard.pipeline import _mimo_stages

from lteax_torch.phy.tuning import OFDM_DFTS, SHIPPED
from lteax_torch.pipeline import make_mimo_batch_decoder
from lteax_torch.sim.mimo_gen import MimoCell, decoder_rows, mimo_subframes

CELL = MimoCell(n_rb_dl=6, cfi=2, mcs=28)
EPS = 1e-7


def _ref_stages(ofdm_dft: str):
    """The reference's MMSE front and turbo stages at its shipped numerics
    with ``ofdm_dft`` (read from the environment when the front traces)."""
    os.environ["LTEAX_OFDM_DFT"] = ofdm_dft
    g = CELL.geom
    f1, f2 = _mimo_stages(
        RefPhyConfig(n_rb_dl=CELL.n_rb_dl, n_ant=2), CELL.n_cell_id,
        CELL.cfi, CELL.prbs, CELL.subframe, CELL.rnti,
        pdsch_ref.pdsch_geometry(g.tbs, g.n_re, g.qm, g.rv), CELL.scheme, 6,
        RefTuning(mdtype="bf16", demap_in="bf16", ofdm_dft=ofdm_dft,
                  ul_dft="fft", ul_planar_boundary=False,
                  mimo_planar_boundary=False, print_iters=True),
        True, tm=CELL.tm, cb_index=CELL.cb_index)
    return jax.jit(f1), jax.jit(f2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=16)
    ap.add_argument("--ref-draws", type=int, default=6)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    iq, tb = mimo_subframes(CELL, 2, snr_db=25.0, seed=9)
    rows = decoder_rows(tb)
    turbo = _ref_stages("fft")[1]
    fronts, shape = {}, None
    for d in OFDM_DFTS:
        fronts[d] = _ref_stages(d)[0]
        llr = fronts[d](jnp.asarray(iq))      # traced under this form
        shape = llr.shape, llr.dtype
        bits, ok, it = turbo(llr)
        print(f"reference front {d}: n_iter {int(it)}, ok "
              f"{np.asarray(ok).tolist()}, bits sent "
              f"{np.array_equal(np.asarray(bits), rows)}")
    for d in OFDM_DFTS:
        dec = make_mimo_batch_decoder(
            *CELL.decoder_args(), n_iter=6, device="cpu",
            tuning=dataclasses.replace(SHIPPED, ofdm_dft=d))
        llr = dec.front(torch.from_numpy(iq))
        bits, ok, it = dec.turbo(llr)
        bits_r, ok_r, it_r = turbo(jnp.asarray(
            llr.float().numpy().reshape(shape[0]), shape[1]))
        print(f"port front {d}: n_iter {it}, ok {ok.tolist()}; the "
              f"reference's turbo stage on its LLRs: n_iter {int(it_r)}, ok "
              f"{np.asarray(ok_r).tolist()}, bits equal "
              f"{np.array_equal(np.asarray(bits_r), bits.numpy())}")
    decs = {d: make_mimo_batch_decoder(
        *CELL.decoder_args(), n_iter=6, device="cpu",
        tuning=dataclasses.replace(SHIPPED, ofdm_dft=d)) for d in OFDM_DFTS}
    for s in range(a.draws):
        rng = np.random.default_rng(100 + s)
        x = (iq * (1 + EPS * rng.standard_normal(iq.shape))).astype(
            np.float32)
        rel = float(np.abs(x - iq).max() / np.abs(iq).max())
        line = (f"IQ x (1 + {EPS:g} N(0,1)), draw {s} (largest change "
                f"{rel:.3g} of the peak): port n_iter")
        for d, dec in decs.items():
            _, ok, it = dec(torch.from_numpy(x))
            line += f" {d} {it}{'' if ok.all() else ' (CRC fails)'}"
        if s < a.ref_draws:
            _, ok_r, it_r = turbo(fronts["fft"](jnp.asarray(x)))
            line += (f"; reference fft n_iter {int(it_r)}"
                     f"{'' if np.asarray(ok_r).all() else ' (CRC fails)'}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
