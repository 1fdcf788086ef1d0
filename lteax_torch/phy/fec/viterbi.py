"""Tail-biting Viterbi decoder for the 36.212 K=7 rate-1/3 code, batched
over codewords (counterpart of ``lteax.phy.fec.viterbi``).

Two wrap-around passes (WAVA): pass 1 from uniform metrics gives
circularly consistent start metrics for pass 2, whose traceback from the
best end state gives the decision.  Codewords are short (PBCH 40 bits),
so the time recursion is a host loop of small batched torch ops; the
throughput comes from decoding every blind-decode hypothesis in one batch.

Ties resolve as ``jnp.argmax`` does, to the first index: a survivor takes
predecessor 1 only when its metric is strictly larger, and the traceback
starts from the first best state.

LLR convention: L = log P(bit=0)/P(bit=1)  (positive => 0).
"""

from __future__ import annotations

import torch

from lteax_torch.phy.fec.conv import trellis_tables


def _wiring(device):
    out_signs, prev_state, ns_input = trellis_tables()
    t = lambda a: torch.as_tensor(a, device=device)
    return t(out_signs), t(prev_state).long(), t(ns_input).long()


def _acs_pass(bm_ns: torch.Tensor, prev_state: torch.Tensor,
              pm: torch.Tensor, keep: bool):
    """bm_ns (N, K, 64, 2) branch metrics per (new state, predecessor),
    pm (N, 64) start metrics.  Returns (final pm, decisions (N, K, 64)
    bool or None)."""
    decs = []
    for k in range(bm_ns.shape[1]):
        cand = pm[:, prev_state] + bm_ns[:, k]           # (N, 64, 2)
        dec = cand[..., 1] > cand[..., 0]
        pm = torch.maximum(cand[..., 0], cand[..., 1])
        pm = pm - pm.amax(dim=-1, keepdim=True)          # normalise
        if keep:
            decs.append(dec)
    return pm, (torch.stack(decs, dim=1) if keep else None)


def viterbi_decode_tb_batch(llrs: torch.Tensor, n_bits: int) -> torch.Tensor:
    """llrs (N, 3, K) float32 soft inputs (stream-major) -> (N, K) int64
    hard bits.  ``n_bits`` must equal K."""
    if llrs.shape[-1] != n_bits:
        raise ValueError(f"n_bits {n_bits} != codeword length "
                         f"{llrs.shape[-1]}")
    out_signs, prev_state, ns_input = _wiring(llrs.device)
    # bm[n, k, s, b] = sum_i out_signs[s, b, i] * llr[n, i, k]
    bm = torch.einsum("sbi,nik->nksb", out_signs, llrs.to(torch.float32))
    bm_ns = bm[:, :, prev_state, ns_input[:, None]]       # (N, K, 64, 2)
    pm0 = torch.zeros((llrs.shape[0], 64), dtype=torch.float32,
                      device=llrs.device)
    pm1, _ = _acs_pass(bm_ns, prev_state, pm0, keep=False)   # warm-up
    pm2, decs = _acs_pass(bm_ns, prev_state, pm1, keep=True)
    state = torch.argmax(pm2, dim=-1)                     # first best
    rows = torch.arange(llrs.shape[0], device=llrs.device)
    bits = []
    for k in range(n_bits - 1, -1, -1):
        bits.append(state >> 5)
        state = prev_state[state, decs[rows, k, state].long()]
    return torch.stack(bits[::-1], dim=-1)
