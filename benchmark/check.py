"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``benchmark/reference.py``) on the same IQ.

Numbers compared, each against its limit in ``limits/<cell>.json``:

- ``llr_sign_gap``: of the de-matched LLRs that the front produced for a
  sample of the checked batch's subframes (drawn from the seed), every
  codeword of each, the share of the sent positions (those where the
  reference's LLR is not 0) whose sign differs from the reference's; an
  LLR of 0 counts as differing.
- ``tb_lost``: of the same sample's transport blocks (``codewords`` a
  subframe, ``benchmark/systems``), the share that the reference decodes
  (every CRC passes, the bits are those sent) and the program does not.
- ``crc_false_pass``: over every batch of the window, the transport blocks
  whose CRCs passed and whose bits are not those sent (exact: limit 0).
  A block whose CRC fails while its payload is right is no fault: its
  CRC24B parity bits can be the ones in error.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference
from benchmark.traffic import seeds


def sample(seed: int, traffic: dict) -> tuple[int, np.ndarray]:
    """(the checked batch's number in the window, the sampled subframe
    rows: ``check_tbs`` of them)."""
    rng = np.random.default_rng(seeds(seed, 3)[2])
    batch = int(rng.integers(traffic["noise_batches"]))
    rows = np.sort(rng.choice(traffic["batch"], traffic["check_tbs"],
                              replace=False))
    return batch, rows


def program_side(record, inputs, rows: np.ndarray, c: int,
                 codewords: int) -> dict:
    """What the reference is judged against, brought to the host before
    the program's state is freed: the sampled subframe rows' IQ, the
    front's LLRs and the outputs of their transport blocks (``c``
    codeblocks each, ``codewords`` a row, b-major in (subframe,
    codeword))."""
    x = inputs.batches[record.kept["batch"] % len(inputs.batches)]
    llr = record.kept["llr"]
    llr = llr.reshape(x.shape[0], codewords * c, *llr.shape[1:])[
        torch.as_tensor(rows, device=llr.device)]
    tbs = (rows[:, None] * codewords + np.arange(codewords)).ravel()
    return {"iq": x[torch.as_tensor(rows, device=x.device)].cpu().numpy(),
            "llr": llr.float().cpu().numpy().reshape(-1, *llr.shape[2:]),
            "bits": record.kept["bits"][tbs], "ok": record.kept["ok"][tbs],
            "sent": inputs.sent_host[tbs],
            "crc_false_pass": record.crc_false_pass}


def compare(system, cfg: dict, side: dict) -> dict:
    """-> {number: value} of the comparison."""
    geom = system.geometry(cfg)
    d_ref = system.reference_front(cfg, side["iq"])
    sent_pos = d_ref != 0
    gap = np.sign(side["llr"][sent_pos]) != np.sign(d_ref[sent_pos])
    bits, ok = reference.decode(d_ref, geom, cfg["n_iter"],
                                cfg["tuning"]["ext_scale"])
    ref_good = ok & np.all(bits == side["sent"], axis=1)
    good = side["ok"] & np.all(side["bits"] == side["sent"], axis=1)
    return {"llr_sign_gap": float(gap.mean()),
            "tb_lost": float(np.mean(ref_good & ~good)),
            "crc_false_pass": side["crc_false_pass"]}


def judged(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit, in the result's ``checks`` form."""
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def correct(checks: dict) -> bool:
    """No number above its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())
