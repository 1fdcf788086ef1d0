"""DL-SCH: ``lteax_torch.pipeline.make_batch_decoder`` on (B, n_samps, 2)
float32 IQ of a full-band PDSCH allocation with one CRS port."""

from __future__ import annotations

from benchmark import lte, reference, tx

transmit = tx.dl_subframes
geometry = tx.dl_geometry
reference_front = reference.dl_front

def decoder(cfg: dict, tuning: dict, device):
    """The program's decoder of ``cfg`` under the tuning profile
    ``tuning`` (the reference's keys, ``DecoderTuning.from_dict``)."""
    from lteax_torch.phy.channels.pdsch import pdsch_geometry
    from lteax_torch.phy.config import PhyConfig
    from lteax_torch.phy.tuning import DecoderTuning
    from lteax_torch.pipeline import make_batch_decoder
    g = geometry(cfg)
    return make_batch_decoder(
        PhyConfig(n_rb_dl=cfg["n_rb"]), cfg["n_cell_id"], cfg["cfi"],
        tuple(range(cfg["n_rb"])), cfg["subframe"], cfg["rnti"],
        pdsch_geometry(cfg["tbs"], g.g // g.qm, g.qm, cfg["rv"]),
        cfg["scheme"], n_iter=cfg["n_iter"],
        tuning=DecoderTuning.from_dict(tuning), device=device)

def demap_columns(cfg: dict) -> tuple[int, int]:
    """(symbols, planar columns) of a subframe's demap: the full grid,
    padded to 128 with at least one pad column."""
    n = 14 * lte.Numerology(cfg["n_rb"]).n_sc
    return n, (n // 128 + 1) * 128
