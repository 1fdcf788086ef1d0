"""PBCH: broadcast channel (36.212 §5.3.1, 36.211 §6.6), counterpart of
``lteax.phy.channels.pbch``.

The 40 ms codeword (MIB 24 bits + CRC16 masked by the antenna count ->
tail-biting convolutional code -> 1920 bits, normal CP) spreads over 4
frames.  A receiver sees one frame's quarter and blindly resolves the
quarter phase and n_ant.  :func:`pbch_blind_decode` runs all 12
(n_ant, quarter) hypotheses as ONE batch — one de-match, one Viterbi, one
CRC — and brings the result to the host in one read.
"""

from __future__ import annotations

import numpy as np
import torch

from lteax.phy.config import PhyConfig
from lteax_torch.host import read
from lteax_torch.phy import seq
from lteax_torch.phy.chest import precode_sfbc, precode_sfbc_fstd
from lteax_torch.phy.fec.conv import conv_encode
from lteax_torch.phy.fec.crc import attach_crc_np, check_crc
from lteax_torch.phy.fec.ratematch import (conv_rm_indices, rate_match,
                                           rate_unmatch)
from lteax_torch.phy.fec.viterbi import viterbi_decode_tb_batch
from lteax_torch.phy.mod import modulate

E_PBCH_NORM = 1920
E_PBCH_EXT = 1728
N_ANT_HYPOTHESES = (1, 2, 4)


def e_pbch(extended_cp: bool = False) -> int:
    return E_PBCH_EXT if extended_cp else E_PBCH_NORM


ANT_MASKS = {
    1: np.zeros(16, dtype=np.int32),
    2: np.ones(16, dtype=np.int32),
    4: np.tile(np.array([0, 1], dtype=np.int32), 8),
}


def pbch_encode_40ms(mib_bits: np.ndarray, n_ant: int, n_cell_id: int,
                     extended_cp: bool = False) -> np.ndarray:
    """MIB (24,) -> (4, E/4) scrambled, rate-matched bit quarters (one per
    frame of the 40 ms TTI)."""
    e_len = e_pbch(extended_cp)
    b = attach_crc_np(np.asarray(mib_bits), "16", mask_bits=ANT_MASKS[n_ant])
    e = rate_match(conv_encode(b), conv_rm_indices(40, e_len))
    e = (e + seq.gold_sequence_np(n_cell_id, e_len)) % 2
    return e.reshape(4, e_len // 4)


def pbch_quarter_to_grid(quarter_bits: np.ndarray, cfg: PhyConfig,
                         n_cell_id: int, n_ant: int) -> dict[int, np.ndarray]:
    """One frame's quarter bits -> {port: (n_re,) complex64} at
    ``pbch_flat_idx``: 1 port direct, 2-port SFBC, 4-port SFBC+FSTD."""
    sym = torch.from_numpy(modulate(quarter_bits, "qpsk"))
    if n_ant == 1:
        ports = (sym,)
    elif n_ant == 2:
        ports = precode_sfbc(sym)
    else:
        ports = precode_sfbc_fstd(sym)
    return {p: v.numpy() for p, v in enumerate(ports)}


def pbch_blind_decode(llrs_by_ant: dict[int, torch.Tensor], n_cell_id: int,
                      extended_cp: bool = False, extra=None):
    """Resolve (n_ant, quarter) from one frame's PBCH LLRs.

    llrs_by_ant: {n_ant hypothesis: (E/4,) raw LLRs in RE order} for
    n_ant 1, 2 and 4.  Hypotheses are tried in the reference's order
    (n_ant 1, 2, 4; quarter 0..3) and the first whose masked CRC holds wins.

    ``extra``: an optional 1-D float tensor on the same device that rides
    along in the one host read; it comes back as a list.

    Returns (mib_bits (24,) or None, n_ant, sfn_mod4, ok[, extra list])."""
    e_len = e_pbch(extended_cp)
    qlen = e_len // 4
    ants = [a for a in N_ANT_HYPOTHESES if a in llrs_by_ant]
    llr = torch.stack([llrs_by_ant[a].to(torch.float32) for a in ants])
    dev = llr.device
    sgn = torch.as_tensor(seq.scrambling_symbols_np(n_cell_id, e_len),
                          device=dev)
    buf = torch.zeros((len(ants), 4, e_len), dtype=torch.float32, device=dev)
    for q in range(4):
        buf[:, q, q * qlen:(q + 1) * qlen] = llr
    buf = (buf * sgn).reshape(len(ants) * 4, e_len)      # (n_hyp, E)
    d_llr = rate_unmatch(buf, conv_rm_indices(40, e_len), 40)
    bits = viterbi_decode_tb_batch(d_llr, 40)            # (n_hyp, 40)
    masks = np.repeat(np.stack([ANT_MASKS[a] for a in ants]), 4, axis=0)
    _, ok = check_crc(bits, "16", mask_bits=masks)
    parts = [ok.to(torch.float32), bits.to(torch.float32).reshape(-1)]
    if extra is not None:
        parts.append(extra.to(torch.float32).reshape(-1))
    host = read(torch.cat(parts))                        # the one read
    n_hyp = len(ants) * 4
    ok_h = host[:n_hyp]
    bits_h = np.asarray(host[n_hyp:n_hyp + n_hyp * 40],
                        dtype=np.int64).reshape(n_hyp, 40)
    rest = host[n_hyp + n_hyp * 40:]
    out = (None, 0, 0, False)
    for h, good in enumerate(ok_h):
        if good:
            out = (bits_h[h, :24], ants[h // 4], h % 4, True)
            break
    return (*out, rest) if extra is not None else out
