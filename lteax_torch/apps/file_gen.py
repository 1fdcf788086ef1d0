"""DL frame generator: synthesize baseband LTE FDD downlink IQ captures;
counterpart of ``lteax.apps.file_gen``.

``GenConfig`` is ``sim.cell_gen.Cell`` with a frame count, and the grids
come from ``cell_gen.build_subframe_grid``: PSS/SSS/CRS/PBCH (MIB),
PCFICH, the SI grants (DCI 1A or 1C) and PDSCH (SIB1 in subframe 5 of even
frames, SI message 1 in subframe 5 of odd frames, SI messages n >= 2 of
``si_schedule`` in their 36.331 §5.2.3 windows) and paging in subframe 9.
Every subframe of the capture is OFDM-modulated in one call on the device
(the card unless the caller asks for the CPU).

    python -m lteax_torch.apps.file_gen --out cap.fc32 [--n-rb 6]
        [--cell-id 0] [--frames 8] [--fmt fc32|sc8] [--tac 0x1234]
        [--n-ant 1|2|4] [--extended-cp] [--si-dci 1a|1c] [--cfi N]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from lteax_torch.io.iq import write_iq
from lteax_torch.phy.config import PhyConfig
from lteax_torch.pipeline import _resolve_device
from lteax_torch.sim import cell_gen


@dataclasses.dataclass(frozen=True)
class GenConfig(cell_gen.Cell):
    n_frames: int = 4

    @property
    def phy(self) -> PhyConfig:
        return self.cfg


def build_subframe_grid(gc: GenConfig, sfn: int, sf: int,
                        pbch_quarters: np.ndarray,
                        sib1_bits: np.ndarray, sib2_bits: np.ndarray,
                        paging_bits: np.ndarray | None = None,
                        extra_si_bits: np.ndarray | None = None
                        ) -> np.ndarray:
    """One subframe's grid, ports superposed, with the reference's
    arguments: the 1A grants at ``gc.sib1_mcs`` as given (``generate``
    raises it until every SI message fits)."""
    paging = (paging_bits if paging_bits is not None and len(paging_bits)
              else None)
    si = cell_gen.SiBits(sib1_bits, (sib2_bits,), paging, gc.sib1_mcs)
    return cell_gen.build_subframe_grid(gc, sfn, sf, pbch_quarters, si,
                                        extra_si_bits)


def generate(gc: GenConfig, device=None) -> np.ndarray:
    """-> (n_frames * 10 * n_samps_subframe,) complex64 baseband from
    subframe 0 of frame 0, modulated on ``device`` (default: the current
    CUDA device; without one this raises unless ``device="cpu"``)."""
    return cell_gen.generate(gc, 10 * gc.n_frames, 0,
                             _resolve_device(device))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="LTE DL IQ file generator")
    p.add_argument("--out", required=True)
    p.add_argument("--n-rb", type=int, default=6)
    p.add_argument("--cell-id", type=int, default=0)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--fmt", choices=("fc32", "sc8"), default="fc32")
    p.add_argument("--tac", type=lambda s: int(s, 0), default=0x1234)
    p.add_argument("--n-ant", type=int, choices=(1, 2, 4), default=1)
    p.add_argument("--extended-cp", action="store_true")
    p.add_argument("--si-dci", choices=("1a", "1c"), default="1a")
    p.add_argument("--cfi", type=int, default=None,
                   help="defaults to 2 (3 for 4-antenna cells)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    a = p.parse_args(argv)
    cfi = a.cfi if a.cfi is not None else (3 if a.n_ant == 4 else 2)
    gc = GenConfig(n_rb_dl=a.n_rb, n_cell_id=a.cell_id, n_frames=a.frames,
                   tac=a.tac, n_ant=a.n_ant, extended_cp=a.extended_cp,
                   si_dci=a.si_dci, cfi=cfi)
    t0 = time.perf_counter()
    x = generate(gc, a.device)
    gen_s = time.perf_counter() - t0
    write_iq(a.out, x, a.fmt)
    print(f"wrote {len(x)} samples ({a.frames} frames, "
          f"{gc.phy.fs / 1e6:.2f} Msps) to {a.out}; generated in "
          f"{gen_s * 1e3 / (10 * a.frames):.3f} ms per subframe")


if __name__ == "__main__":
    main()
