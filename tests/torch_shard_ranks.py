"""What each gloo rank of ``tests/test_torch_shard.py`` runs (imported by
name in the spawned ranks, so it imports the port, torch and numpy only):
on each mesh shape, the halo exchange, the correlation, the sharded DL,
acquire, UL, HARQ, TM3 MMSE and TM4 SIC decoders and the sharded prescan,
each on this rank's slice of the global inputs; the results as numpy."""

import sys

import numpy as np
import torch

from lteax_torch.phy.tuning import DecoderTuning
from lteax_torch.shard import pipeline as sp
from lteax_torch.shard.halo import exchange_right_halo, overlap_save_correlate
from lteax_torch.shard.mesh import (CHAN_AXIS, TIME_AXIS, local_slice,
                                    make_mesh)
from lteax_torch.shard.scanner import batched_prescan, \
    make_sharded_pss_detector
from lteax_torch.sim.dl_gen import harq_decoder_args

CPU = "cpu"


def _decode(dec, x):
    bits, ok, n_ok, *peak = dec(torch.from_numpy(x))
    return {"bits": bits.numpy(), "ok": ok.numpy(), "n_ok": n_ok,
            "n_iter": dec.last_stats.n_iter, **(
                {"peak": peak[0]} if peak else {})}


def _mesh_cases(mesh, inp: dict) -> dict:
    t = lambda x, axis=0: local_slice(x, mesh, axis, TIME_AXIS)
    out = {"coord": (mesh.get_local_rank(CHAN_AXIS), mesh.get_local_rank(TIME_AXIS))}
    out["halo"] = exchange_right_halo(torch.from_numpy(t(inp["halo_x"])),
                                      inp["halo"], mesh).numpy()
    out["corr"] = overlap_save_correlate(
        torch.from_numpy(t(inp["corr_x"])),
        torch.from_numpy(inp["corr_taps"]), mesh).numpy()
    dl, ul = inp["dl_cell"], inp["ul_cell"]
    out["dl"] = _decode(sp.make_sharded_decoder(
        mesh, *dl.decoder_args(), device=CPU), t(inp["dl_iq"]))
    out["acquire"] = _decode(sp.make_sharded_acquire_decoder(
        mesh, *dl.decoder_args(), device=CPU), t(inp["dl_iq"]))
    out["ul"] = _decode(sp.make_sharded_pusch_decoder(
        mesh, *ul.decoder_args(), device=CPU), t(inp["ul_iq"]))
    hargs = harq_decoder_args(inp["harq_cells"])
    out["harq"] = _decode(sp.make_sharded_harq_decoder(
        mesh, *hargs, device=CPU), t(inp["harq_iq"], 1))
    out["harq_rv0"] = _decode(sp.make_sharded_decoder(
        mesh, *inp["harq_cells"][0].decoder_args(), device=CPU),
        t(inp["harq_iq"][0]))
    tm3, tm4 = inp["tm3_cell"], inp["tm4_cell"]
    out["tm3"] = _decode(sp.make_sharded_mimo_decoder(
        mesh, *tm3.decoder_args(), **tm3.precoding, device=CPU),
        t(inp["tm3_iq"], 1))
    out["sic"] = _decode(sp.make_sharded_mimo_decoder(
        mesh, *tm4.decoder_args(), **tm4.precoding,
        tuning=DecoderTuning(mimo_detector="sic"), device=CPU),
        t(inp["sic_iq"], 1))
    caps = torch.from_numpy(inp["captures"])
    out["prescan"] = batched_prescan(caps, inp["cfg"], mdtype="f32",
                                     mesh=mesh)
    pad = np.concatenate([inp["captures"], np.zeros(
        (1, inp["captures"].shape[1]), np.complex64)])
    det = make_sharded_pss_detector(mesh, inp["cfg"], pad.shape[1],
                                    mdtype="f32")
    out["n_det"] = det(torch.from_numpy(local_slice(pad, mesh, 0,
                                                    CHAN_AXIS)))[-1]
    return out


def run(inp: dict) -> dict:
    """Every case on every mesh shape of ``inp["meshes"]``, and the
    foreign modules this rank loaded (it must load none)."""
    res = {shape: _mesh_cases(make_mesh(*shape, device=CPU), inp)
           for shape in inp["meshes"]}
    res["foreign"] = foreign_modules()
    return res


def foreign_modules() -> list:
    """The jax and lteax modules this process has loaded (a rank must
    load none)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "lteax"))
