"""UL-SCH (PUSCH data): ``lteax_torch.pipeline.make_pusch_batch_decoder``
on (B, 14, m_sc, 2) float32 gridded SC-FDMA subframes."""

from __future__ import annotations

from benchmark import reference, tx

transmit = tx.ul_subframes
geometry = tx.ul_geometry
reference_front = reference.ul_front


def decoder(cfg: dict, tuning: dict, device):
    """The program's decoder of ``cfg`` under the tuning profile
    ``tuning`` (the reference's keys, ``DecoderTuning.from_dict``)."""
    from lteax_torch.phy.channels.pusch import PuschAlloc
    from lteax_torch.phy.tuning import DecoderTuning
    from lteax_torch.pipeline import make_pusch_batch_decoder
    alloc = PuschAlloc(n_prb=cfg["n_prb"], rb_start=0, mcs_tbs=cfg["tbs"],
                       qm=cfg["qm"], rv=cfg["rv"])
    return make_pusch_batch_decoder(
        alloc, cfg["rnti"], cfg["subframe"], cfg["n_cell_id"],
        n_iter=cfg["n_iter"], tuning=DecoderTuning.from_dict(tuning),
        device=device)


def demap_columns(cfg: dict) -> tuple[int, int]:
    """(symbols, planar columns) of a subframe's demap: the 12 data
    symbols' subcarriers, padded to 128."""
    n = 12 * 12 * cfg["n_prb"]
    return n, -(-n // 128) * 128
