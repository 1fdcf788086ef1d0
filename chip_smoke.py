#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``lteax_torch/kernels/csrc`` with nvcc
(sm_90a, one nvcc per source, in parallel), holds each kernel against its
plain torch version on the card at the main paths' shapes, then drives
twenty-six paths, each with the launch counters set to 0 just before it
and read just after (in the ranks of the multi-process paths, summed over
them from what each rank returns):

1. DL-SCH decode through ``lteax_torch.pipeline.make_batch_decoder`` at the
   ``bench.py`` headline configuration (20 MHz, 100 PRB, MCS 28, TBS 75376,
   C=13 x K=5824) on 256 subframes at 25 dB from ``lteax_torch.sim.dl_gen``
   (seed 0): every transport block must decode to the bits sent, and the
   card's decode of a small slice must equal the CPU's.
2. The multi-carrier cell scanner through
   ``lteax_torch.apps.scanner.scan_channels(..., prescan=True)`` at 20 MHz:
   16 captures of 20 ms at 20 Msps from ``lteax_torch.sim.cell_gen``
   (seed 0), 12 live cells and 4 dead channels, resampled 192/125 to
   30.72 Msps (the captures are made at 20 Msps by the resampler kernel on
   the card, one launch a live capture); every live cell must report the cell id, antenna count and
   MIB it was made with and the SIB its first subframe 5 carries (SIB1 in
   an even frame, SIB2 in an odd one) with no SI CRC failure, every dead
   channel none; one capture's scan on the card must match its scan on the
   CPU; each live capture is also scanned with and without the SI stage,
   in turns, to give the SI stage's cost.
   The PSS correlator runs its default, the bf16 tensor-core kernel;
   ``lteax_torch.phy.sync.find_pss(..., mdtype="f32")`` on one capture
   drives the direct f32 kernel and must give the same root within one
   sample of the default's index.
3. The PSS band sweep (``lteax_torch.bench.scan_throughput.detect``, the
   fused detect kernel) over 128 carriers x 20 subframes of 20 MHz: every
   carrier must give root 1 at the plain version's index, within 8 samples
   of the inserted PSS, in bf16 (the default) and in f32.
4. UL-SCH decode through ``lteax_torch.pipeline.make_pusch_batch_decoder``
   at the ``bench/ul_throughput.py`` configuration (100 PRB, TBS 75376,
   64QAM, cell 214, subframe 4, RNTI 0x3D) on 256 gridded subframes at
   25 dB from ``lteax_torch.sim.ul_gen`` (seed 0): every transport block
   must decode to the bits sent, and a small slice as on the CPU.
5. HARQ incremental redundancy through
   ``lteax_torch.pipeline.make_batch_harq_decoder`` at the
   ``bench/harq_throughput.py`` configuration (20 MHz, MCS 28, subframes
   (1, 2), rv (0, 2)) on 64 transport blocks at ``HARQ_SNR_DB``, where the
   rv 0 transmission alone must decode none of them and the combination all
   of them; then both decoders are timed at 25 dB.
6. The ACS op-mix probe through ``lteax_torch.bench.acs_probe.run`` (f32 and
   packed bf16, 2 097 152 elements, 512 rounds).
7. 2x2 MIMO through ``lteax_torch.pipeline.make_mimo_batch_decoder``
   (``lteax_torch.sim.mimo_gen``, seed 0): TM3 at the
   ``bench/mimo_throughput.py`` defaults (100 PRB, MCS 28, channel "bench",
   25 dB) on 256 subframes, every one of the 512 transport blocks decoded to
   the bits sent; the tracked TM4 configuration (codebook 0, MCS 24, channel
   "corr", 28 dB) on 192 subframes through the MMSE and the SIC decoder on
   the same IQ, SIC decoding all 384 and no fewer than MMSE; both decoders'
   card decode of 4 subframes equal to the CPU's; the SIC stages and the
   re-encode timed; the turbo kernel at the MIMO shape, C = 6656.
8. SI decode (``[si]``) through ``scan_channels(..., prescan=True)``: four
   40 ms captures of 20 MHz cells (SNR 10-20 dB, CFO within 5 kHz): one
   port with DCI 1A grants, two ports with DCI 1C grants and two paged
   S-TMSIs, four ports, and one at 20 Msps through the resampler; each
   must report the SIB1, SIB2 and paging it was made with, and one
   channel's scan on the card must equal its scan on the CPU in every
   integer field, the MIB and the SIBs.  The turbo kernel at the SI shape
   (C = 1, K 224 and 408, window 32) bit for bit against its plain version.
9. A wrapping rate match (``[dl-wrap]``): the DL decoder at 100 PRB MCS 0
   (TBS 2792, C=1, K=2816, G 30000 over 3 * 2820: four cycles of the
   circular buffer) on 256 subframes at ``WRAP_SNR_DB``, every transport
   block decoded to the bits sent, the card's decode of 4 equal to the
   CPU's.
10. The UE-specific control decode (``[ctrl]``): two 20 MHz subframes
    (100 PRB, cfi 3, one port, 20 dB) from ``lteax_torch.sim.ctrl_gen``
    carrying a C-RNTI DCI of each of formats 0, 1, 1B, 1D, 2 and 2A at
    UE-space candidates of L 1, 2, 4 and 8 (2 and 2A at 2, 4 and 8), DCI 3
    and 3A on TPC-RNTIs in the common space, and all 8 HI bits of every
    PHICH group; OFDM, the CRS channel estimate, the PCFICH, every blind
    decode (``pdcch.pdcch_blind_decode_*``) and the PHICH decode
    (``phich.phich_decode_subframe``) on the card: every DCI found at its
    (start, L) with its fields, every HI bit right, the card's result equal
    to the CPU's.
11. The single-subframe UL decodes (``[ul-single]``, ``[ul-uci]``): 8
    subframes of the UL cell at 25 dB through ``pusch.pusch_decode`` and,
    with 2 HARQ-ACK and 1 RI bit multiplexed, ``pusch.pusch_decode_uci``:
    CRC, bits, ACK and RI right; 12 turbo launches a subframe, the demap
    kernel none; the card equal to the CPU on one subframe.
12. The UL bench CLI (``[ul-bench]``): ``lteax_torch.bench.ul_throughput``
    at B=256, its JSON line, 256/256 CRC.
13. Config #2 (``[bler]``): the gate of ``tests/test_snr_sweep.py`` through
    ``lteax_torch.bench.snr_sweep.bler_gate`` for the stored 6-PRB MCS 4
    and 25-PRB MCS 10 curves, each point within its ±0.5 dB band, BER 0 at
    the zero + 0.5 dB point; then config #2's own sweep (25 PRB, MCS 10,
    50 blocks, 7 points).
14. Config #3 (``[config3]``): the three gates of
    ``lteax_torch.bench.config3`` on the card (the noise estimate and
    MMSE-below-LS under EVA, the 2-port SFBC loopback with MIB, SIB1, SIB2
    and no SI CRC failure) at 50 PRB.

15. Config #1 (``[loopback]``): ``python -m lteax_torch.apps.file_gen``
    then ``python -m lteax_torch.apps.file_scan`` as subprocesses on the
    card, for config #1 (6 PRB, cell 214, 8 frames), the same at 100 PRB
    (4 frames) and as an sc8 file, in parallel: cell 214, the MIB, SIB1,
    SIB2, no SI CRC failure, the report equal (parsed) to the CPU's scan
    and to a counted in-process scan on the card of the same file; then
    ``file_gen.generate()`` at 100 PRB with extended CP and with SIB3/5/9
    on a three-message SI schedule, every SIB recovered.
16. The streaming scanner (``[stream]``): a 20 MHz fc32 file of 24 frames
    (7.37 M samples, 59 MB) through ``StreamScanService`` in windows of 60
    subframes: one run with ``status`` read over the ctrl socket while it
    runs; 2 windows, stop, resume to 4, the reports equal the one-shot
    run's; the native reader against numpy (MB/s); TCP ingest of the file
    (Msps, drops); one window streamed over TCP from a local sender
    thread, no drop, its report equal to the file window's; the
    recorder's sc8 -> fc32 equal to ``read_iq``'s.
17. IQ staging (``[iq]``): the DL bench CLI at B=256 with ``--iq`` f32,
    bf16 and sc8, each 256/256 with the bits sent; ``prefetch_to_device``
    feeding 8 batches of 256, against a plain copy before each decode.
18. Tracing (``[trace]``): the DL bench CLI's ``--trace`` around one
    decode of 32 subframes; the Chrome trace holds the ``decode_batch``
    range and the turbo and demap kernels.
19. The UL control PHY (``[ulctrl]``): PRACH format 0 at 30.72 Msps, the
    64 preambles of ``preamble_set(22, 12)`` (N_cs 119) and of the
    high-speed ``preamble_set(22, 5, True)`` (N_cs 38), each a burst with a
    random delay inside its zone at 10 and at 0 dB, detected on the card
    (``prach.detect_prach_cv``) with the sent preamble first at its delay
    and the (index, delay) list equal to the CPU's, formats 1-3 once each,
    noise alone never detected; PUCCH formats 1/1a/1b (three orthogonal
    covers on one resource), 2, 2a and 2b at both band edges of a 100-PRB
    grid and SRS at m_srs 96, every decision equal to the CPU's and to
    what was sent.
20. The attach simulators (``[attach]``): ``apps.attach_sim.run`` on the
    card (7 stages; 10 turbo launches a transport block, 80 in all) and on
    the CPU, each PRACH detection's (index, delay) and each of the 8
    transport blocks' decoded bytes equal between the two;
    ``apps.rrc_attach_sim.run`` on the card (RRC attach, AS security, user
    plane, handover with the target cell's dedicated RACH); ms per
    ``_dl_sch`` / ``_ul_sch`` transport block.
21. The eNB (``[enb]``) at 20 MHz (100 PRB) through ``apps.enb_sim`` and
    ``apps.enb_service`` on the card, then on the CPU with the same
    inputs: the traffic of the reference's two-UE user plane test (two
    frames), and its UL control loop (SR, DCI 0, PUSCH, HARQ ACK / NACK on
    PUCCH formats 1 and 2a, CQI on 2 and 2a, the PHICH's HI), what each
    side decoded equal (SDUs, STATUS PDUs, HARQ bits, decisions, HI);
    the traffic of the reference's lost-subframe test (1 UE) and of its
    two-UE user plane test timed a TTI, by stage, with host reads, K1/K2
    launches (K3 asserted 0) and the device's busy share over the same
    20 TTIs (profiled again); ``EnbService`` at
    bandwidth 100 over its ctrl socket (add_user, start, add_ue, step to
    connected, ping, detach_ue), its replies and the UE's SDUs equal to the
    CPU run's, its IQ scanned back by ``file_scan.scan`` to its cell, MIB
    and SIB1; the two-cell handover over the TTI loop (the reference's
    ``test_handover_sim.py``, 1 UE with UL and DL each TTI), timed a
    TTI.
22. The HARQ bench CLI (``[harq-bench]``): ``lteax_torch.bench.
    harq_throughput`` at its defaults (B=384, 25 dB, bf16 IQ), its JSON
    line, every block decoded by both decoders, its overhead ratio beside
    ``[harq]``'s.
23. The sharded decoders (``[shard]``) of ``lteax_torch.shard.pipeline``
    on an in-process NCCL group of one rank (a 1x1 mesh), each at its
    phase's configuration on 64 subframes: DL, the halo PSS acquire decoder
    (its ``pss_peak`` within 1e-5 of a float64 correlation) and UL at
    100 PRB MCS 28, HARQ at ``HARQ_SNR_DB``, TM3 MMSE and TM4 SIC: bits and
    flags equal the single-device decoder's on the same IQ, every block
    decoded; the DL decode timed sharded and not, in turns; the sharded
    prescan of 4 of the scanner's captures equal to the one-device one.
24. Two ranks on one card (``[shard-2rank]``): ``shard.dryrun.
    dryrun_multichip(2, backend="gloo")``, spawned ranks sharing cuda:0 on
    the 1x2 and 2x1 meshes (the acquire case at 100 PRB MCS 28, its halo
    across the ranks; every case's bits equal those sent), and the
    channel-sharded prescan of 4 of the scanner's captures equal to the
    one-device prescan; each rank's turbo, demap and PSS launches > 0.  Not
    a scaling number.
25. The scaling CLI (``[scaling]``): ``python -m lteax_torch.bench.scaling
    --nproc 1`` at 100 PRB MCS 28, 64 subframes: the 1-device baseline, its
    JSON line.
26. The multi-host scanner (``[multihost]``): ``python -m
    lteax_torch.apps.scanner --multihost 2 --prescan`` on the same 4
    captures at 20 Msps: each worker's reports equal the one-process
    scan's, both workers' totals the live count.
27. The reference's shipped numerics (``[bf16]``, ``phy.tuning.SHIPPED``:
    bf16 trellis, bf16 demap staging): the DL headline (B=256, 25 dB)
    under ``SHIPPED`` and under the f32 default on the same IQ, timed in
    turns, 256/256 with the bits sent under both; the threshold cells
    (21.5 and 20.5 dB, B=256) under both, CRC counts; UL, HARQ (15 dB),
    TM3 MMSE and TM4 SIC at B=64 under ``SHIPPED`` (and f32 on the same
    IQ), every block decoded; the bf16_f32store (the bf16 kernel with an
    f32 extrinsic carry) and freeze trellises on 64 DL subframes.  Their
    kernel forms (turbo bf16 and bf16 freeze; demap bf16 in and out at the
    DL and UL shapes, and f32 in with bf16 out for SIC's front) are held to
    their plain versions at the main paths' shapes beforehand and counted
    in these runs; the turbo bf16 forms also at the ragged and SI shapes
    and at those the bf16 kernel's layout must survive (``TURBO_BF16``),
    and the bf16 kernel's variants (``BF16_VARIANTS``, lever by lever) are
    timed in turns with the f32 form at the main shape.

Any failure raises (exit code != 0).  Every timing line carries the card's
name and power limit.  The last line is one JSON object naming the
device; the one before it lists the kernels with their launch counts,
errors, times and bounds.  A kernel's bound is the least time the card
could take for the same work: the larger of its bytes (each input read
once, each output written once) over the memory rate and its operations
over the peak rate of their type, from the published peaks of the H100 SXM
below.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import shutil
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import lteax_torch.apps.file_scan as file_scan
import lteax_torch.apps.scanner as scanner
from lteax_torch.apps import (attach_sim, enb_service, enb_sim, file_gen,
                              recorder, rrc_attach_sim)
from lteax_torch.apps.stream_scan import StreamScanService
import lteax_torch.kernels.acs_probe as acs_mod
import lteax_torch.kernels.demap as demap_mod
import lteax_torch.kernels.polyphase as poly_mod
import lteax_torch.kernels.pss as pss_mod
import lteax_torch.kernels.turbo_mlm as turbo_mod
import lteax_torch.phy.sync as sync
from lteax_torch import host
from lteax_torch.bench import (acs_probe, config3, dl_throughput,
                               harq_throughput, resample_bench,
                               scan_throughput, snr_sweep, ul_throughput)
from lteax_torch.bench.timing import (IQ_FORMATS, card_line, stage_iq,
                                      time_decode)
from lteax_torch.bench import scaling as scaling_bench
from lteax_torch.io import native
from lteax_torch.io.iq import prefetch_to_device, read_iq, write_iq
from lteax_torch.kernels._build import library
from lteax_torch.phy import chest, seq
from lteax_torch.phy.channels import pdsch as pdsch_mod
from lteax_torch.phy.channels import (pcfich, pdcch, phich, prach, pucch,
                                      pusch, srs)
from lteax_torch.phy.config import PhyConfig
from lteax_torch.phy.fec.reencode import turbo_reencode_batch
from lteax_torch.phy.fec.turbo import turbo_encode
from lteax_torch.phy.grid import pcfich_flat_idx, pdcch_flat_idx
from lteax_torch.phy.mod import demodulate_maxlog
from lteax_torch.phy.ofdm import samples_to_subframe, subframe_to_samples
from lteax_torch.kernels import launch_counts, reset_launch_counts
from lteax_torch.phy.tuning import SHIPPED, DecoderTuning
from lteax_torch.pipeline import (dl_demap_plans, make_batch_decoder,
                                  make_batch_harq_decoder,
                                  make_mimo_batch_decoder,
                                  make_pusch_batch_decoder)
from lteax_torch.shard import pipeline as shard_pipeline
from lteax_torch.shard.dryrun import dryrun_multichip
from lteax_torch.shard.mesh import make_mesh, process_group
from lteax_torch.shard.scanner import batched_prescan
from lteax_torch.sim import cell_gen, ctrl_gen
from lteax_torch.sim.dl_gen import (DlCell, dl_subframes, harq_decoder_args,
                                    harq_transmissions)
from lteax_torch.sim.mimo_gen import MimoCell, decoder_rows, mimo_subframes
from lteax_torch.sim import ul_gen
from lteax_torch.sim.ul_gen import UlCell, ul_subframes
from lteax_torch.stack import rrc, security
from lteax_torch.stack.rrc_dedicated import MeasResultEutra
from lteax_torch.stack.rrc_proc import EnbRrc, UeRrc
from lteax_torch.stack.users import Hss, UserManager

BATCH = 256
SNR_DB = 25.0
SEED = 0
DECODE_REPS = 110     # median and p90 each with >= 10 samples beyond
UL_REPS = 20
HARQ_BATCH = 64
HARQ_SUBFRAMES, HARQ_RVS = (1, 2), (0, 2)
HARQ_SNR_DB = 15.0    # rv 0 alone decodes 0/64 here, rv 0 + rv 2 64/64
HARQ_REPS = 30
PROBE_ROUNDS = (8, 64, 512)
MIMO_TM3 = MimoCell()                    # bench/mimo_throughput.py defaults
MIMO_TM4 = MimoCell(mcs=24, tm=4, cb_index=0)
MIMO_TM4_BATCH, MIMO_TM4_SNR_DB = 192, 28.0
MIMO_REPS = 20
SI_S = 0.04                              # 40 ms per [si] capture
SI_TMSI = (0x0123456789, 0x0200000042)   # S-TMSIs paged on one [si] cell
WRAP_CELL = DlCell(mcs=0)    # 100 PRB MCS 0: TBS 2792, C=1, K=2816, 4 cycles
WRAP_CYCLES = 4
WRAP_SNR_DB = -1.0           # 256/256 in 2 iterations (one compacted retry)
WRAP_REPS = 20
CTRL_CFG = PhyConfig(n_rb_dl=100)
CTRL_CID, CTRL_CFI, CTRL_NG, CTRL_SNR_DB = 301, 3, 1.0, 20.0
# subframe -> the aggregation levels of its UE DCIs: every UE format at
# both, but formats 2 and 2A (51 and 48 payload bits at 100 PRB) never at
# L = 1 (72 coded bits)
CTRL_LEVELS = {1: (8, 1), 6: (4, 2)}
CTRL_TPC = [("3", 0xFFF0, 0, 4), ("3a", 0xFFF1, 4, 4)]
UL_SINGLE_N = 8
UCI = pusch.PuschUci(n_ack=2, n_ri=1)
UCI_ACK, UCI_RI = (1, 0), (1,)
BLER_CURVES = ((6, 4), (25, 10))
CONFIG2 = dict(n_rb=25, mcs=10, n_blocks=50)     # configs/config2_*.yaml
# (C, n, win, acq) of the SI path's turbo decode: one codeblock, K 224 and
# 408, the single-subframe window of 32
TURBO_SI = ((1, 227, 32, 16), (1, 411, 32, 16))

# Published peaks of one H100 SXM (NVIDIA's data sheet and the Hopper
# white paper): device memory, f32 outside the tensor cores counted as
# NVIDIA does (a fused multiply-add is 2), and the same pipes' instruction
# rate for adds, maxes and mins, which cannot fuse: one per lane and clock,
# half the flop figure.  Packed bf16 pairs run two lanes per instruction
# (the white paper's 133.8 TFLOP/s outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F32_OPS_PER_S = 33.5e12
BF16X2_OPS_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

SCAN_CFG = PhyConfig(n_rb_dl=100)
SDR_RATE = 20e6       # the captures' rate; the scanner resamples 192/125
SCAN_S = 0.02         # 20 ms per capture
N_LIVE, N_DEAD = 12, 4
SWEEP_CARRIERS, SWEEP_SF, SWEEP_REPS = 128, 20, 5
PSS_CHECK_SHAPE = (4, 20 * SCAN_CFG.n_samps_subframe)   # K4/K5 vs plain
# (C, n, win, acq) that exercise the turbo kernel's masks and halos: a C that
# is no multiple of anything, K = 40 in one window, a last window with 3
# live positions (K = 1152), a block grid with dead windows (K = 5824)
TURBO_RAGGED = ((37, 43, 128, 16), (37, 1155, 128, 16), (131, 5827, 128, 16),
                (5, 43, 32, 8))
# ... and what the bf16 kernel's layout (two codeblocks a lane, the slab
# staged by cp.async) must survive besides: an odd C at the main shape (the
# last pair's high half dead), win 36 (renormalised every 2 steps), last
# windows whose dead steps number 122 and 123 (t_pin of either parity)
TURBO_BF16 = ((3329, 5827, 128, 16), (37, 1027, 36, 16), (38, 1030, 128, 16),
              (37, 1029, 128, 16))
REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"
# [loopback]: config #1 (configs/config1_loopback_1p4.yaml) and its 100-PRB
# (4 frames: the CPU's plain PSS correlator is the comparison's cost) and
# sc8 variants, as (name, n_rb, frames, fmt)
LOOP_CELL = 214
LOOP_CASES = (("config1", 6, 8, "fc32"), ("config1_100prb", 100, 4, "fc32"),
              ("config1_sc8", 6, 8, "sc8"))
STREAM_CELL, STREAM_FRAMES, STREAM_WINDOW_SF = 301, 24, 60
IQ_REPS = 20
TRACE_BATCH = 32
PRACH_ROOT = 22            # rootSequenceIndex of the [ulctrl] PRACH sets
PRACH_ZCZC = 12            # N_cs 119: 7 shifts a root, 10 roots
PRACH_ZCZC_HS = 5          # high-speed N_cs 38: 5-7 shifts a root, 11 roots
PRACH_SNRS = (10.0, 0.0)   # dB per sample
# noise alone: |corr|^2 / mean is exponential, so the default threshold 8
# passes e^-8 of the 833 zone bins (0.28 false alarms a window, in the
# reference too); 16 passes 9e-5 a window
PRACH_NOISE_THRESHOLD = 16.0
PUCCH_N_RB = 100
PUCCH_CID = 214
PUCCH_SNR_DB = 15.0        # the presence detector's 0.1 sits above noise
SRS_U, SRS_M = 11, 96
ATTACH_K = (280, 352, 528, 1056)   # TBS 256, 328, 504, 1032 + CRC24A
ATTACH_STAGES = {"prach": True, "rar": True, "rrc_request": True,
                 "attach_request": True, "aka": True, "smc": True,
                 "bearer": True}
RRC_STAGES = {"rach": True, "as_security": True, "attach": True,
              "user_plane": True, "handover": True}

ENB_N_RB = 100             # [enb]: 20 MHz
ENB_CID = 77               # the reference tests' cell
ENB_SVC_CID = 133          # the service's cell (its IQ is scanned back)
ENB_K = (bytes(range(32)), bytes(range(1, 33)))   # the UEs' K_eNB
ENB_IMSI = "001011234567890"
ENB_K_HEX = "465b5ce8b199b49faa5f0a2ee238a6bc"
ENB_OPC_HEX = "cd63cb71954a9f4e48a5994e37a02baf"
ENB_GRID_TOL = 0.0         # the DL grids are built on the host: equal
ENB_IQ_TOL = 1e-5          # the service's IQ: cuFFT vs the CPU's FFT
ENB_HO_N_RB = 100          # the handover's bandwidth

SHARD_B = 64               # [shard]: subframes (TM3 / TM4: x 2 codewords)
SHARD_REPS = 20            # [shard]: DL decodes timed, sharded and not
SHARD_PEAK_TOL = 1e-5      # pss_peak vs a float64 FFT correlation
SHARD_CHANS = slice(10, 14)   # [shard-2rank], [multihost]: 2 live, 2 dead
SCALING_PER_DEV, SCALING_REPS = 64, 20

SOURCES = {
    "demap": ("lteax_torch/kernels/csrc/demap.cu",
              "lteax/kernels/demap.py:68"),
    "demap (UL shape)": ("lteax_torch/kernels/csrc/demap.cu",
                         "lteax/kernels/demap.py:68"),
    "turbo_half_iteration": ("lteax_torch/kernels/csrc/turbo.cu",
                             "lteax/kernels/turbo_mlm.py:536"),
    "pss_corr_mag": ("lteax_torch/kernels/csrc/pss.cu",
                     "lteax/kernels/pss.py:55"),
    "pss_detect": ("lteax_torch/kernels/csrc/pss.cu",
                   "lteax/kernels/pss.py:134"),
    "pss_corr_mag_bf16": ("lteax_torch/kernels/csrc/pss.cu",
                          "lteax/kernels/pss.py:55"),
    "pss_detect_bf16": ("lteax_torch/kernels/csrc/pss.cu",
                        "lteax/kernels/pss.py:134"),
    "resample_poly": ("lteax_torch/kernels/csrc/polyphase.cu",
                      "lteax/kernels/polyphase.py:60"),
    "acs_probe": ("lteax_torch/kernels/csrc/acs_probe.cu",
                  "bench/vpu_bf16_probe.py:39"),
    **{f"turbo_half_iteration_{f}": ("lteax_torch/kernels/csrc/turbo.cu",
                                     "lteax/kernels/turbo_mlm.py:536")
       for f in ("bf16", "bf16_freeze")},
    **{f"demap_{f}": ("lteax_torch/kernels/csrc/demap.cu",
                      "lteax/kernels/demap.py:68")
       for f in ("bf16", "bf16 (UL shape)", "bf16_out")},
}
# [bf16]: the threshold cells of the DL headline; B of the other cells
BF16_THRESHOLD_DB = (21.5, 20.5)
BF16_B = 64
BF16_REPS = 20


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str | None = None,
              count: bool = False):
    """Mean device time of the kernels whose name holds ``kernel`` (None:
    every kernel and copy) in one call of ``fn``, from ``torch.profiler``
    over ``reps`` calls of the device's activity alone (CUDA events around
    back-to-back calls of a tiny launch measure the host's launch rate
    instead); None when the profiler sees no such kernel.  The ranges of
    ``record_function`` annotations (``utils.trace.stage``) show on the
    device's timeline too and are left out: they span kernels, not add to
    them.  With ``count`` -> (that time, the number of those kernels a
    call)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation
              and (kernel is None or kernel in e.key)]
    us = sum(e.self_device_time_total for e in events)
    ms = us / reps / 1e3 if us > 0 else None
    return (ms, sum(e.count for e in events) / reps) if count else ms


def _ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def check_demap(name: str, sgn: np.ndarray, n: int, scheme: str, dev,
                in_dt: torch.dtype = torch.float32,
                out_dt: torch.dtype = torch.float32) -> dict:
    """Demap kernel vs plain on (256, n) columns with the sign planes
    ``sgn`` (m, npad) of a main path, inputs staged in ``in_dt`` and the
    LLRs written in ``out_dt``."""
    m, npad = sgn.shape
    rng = np.random.default_rng(SEED)
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=dev).to(in_dt)
    xr = t(rng.standard_normal((BATCH, n)) * 0.7)
    xi = t(rng.standard_normal((BATCH, n)) * 0.7)
    inv_nv = t(rng.uniform(10.0, 1000.0, (BATCH, n)))
    sgn = torch.as_tensor(sgn, device=dev)
    got = demap_mod.demap_planar(xr, xi, inv_nv, sgn, scheme, out_dt)
    ref = demap_mod.demap_planar_plain(xr, xi, inv_nv, sgn, scheme, out_dt)
    torch.cuda.synchronize()
    if got.shape != (BATCH, m, npad) or got.dtype != out_dt or \
            not torch.equal(got, ref):
        raise AssertionError(f"{name} kernel != plain: max |err| "
                             f"{max_abs_err(got, ref)}")
    ms = cuda_time_ms(lambda: demap_mod.demap_planar(xr, xi, inv_nv, sgn,
                                                     scheme, out_dt), 50)
    plain_ms = cuda_time_ms(lambda: demap_mod.demap_planar_plain(
        xr, xi, inv_nv, sgn, scheme, out_dt), 10)
    # per column and axis: L distances (sub, mul), m/2 bits of L-2 mins,
    # and sub, mul, mul per LLR
    lv = 2 ** (m // 2)
    ops = BATCH * npad * 2 * (2 * lv + (m // 2) * (lv - 2 + 3))
    isz, osz = xr.element_size(), got.element_size()
    return {"name": name, "shape": [BATCH, n, m, npad],
            "max_abs_err": max_abs_err(got, ref), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            **bound(isz * 3 * BATCH * n + 4 * m * npad
                    + osz * BATCH * m * npad, ops, F32_OPS_PER_S)}


def check_acs_probe(dev) -> dict:
    """ACS chain kernel vs plain, f32 and packed bf16, at the probe's
    2 097 152 elements and 8, 64 and 512 rounds, ``torch.equal``; times and
    rates at 512 rounds."""
    out = {"name": "acs_probe", "library_ms": None, "max_abs_err": 0.0}
    for name, dt in acs_probe.DTYPES.items():
        x = acs_probe.probe_input(64, dt, dev)
        for rounds in PROBE_ROUNDS:
            got = acs_mod.acs_chain(x, rounds)
            ref = acs_mod.acs_chain_plain(x, rounds)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                bad = got != ref
                raise AssertionError(
                    f"acs_probe {name} kernel != plain at {rounds} rounds: "
                    f"{int(bad.sum())} elements differ")
        n, rounds = x.numel(), PROBE_ROUNDS[-1]
        ms = cuda_time_ms(lambda: acs_mod.acs_chain(x, rounds), 20)
        plain_ms = cuda_time_ms(lambda: acs_mod.acs_chain_plain(x, rounds), 2)
        b = bound(2 * n * x.element_size(), 4 * rounds * n,
                  F32_OPS_PER_S if name == "f32" else BF16X2_OPS_PER_S)
        tops = 4 * rounds * n / (ms * 1e-3) / 1e12
        pre = "" if name == "f32" else "bf16_"
        out.update({pre + "ms": ms, pre + "plain_ms": plain_ms,
                    pre + "tops": tops,
                    **{pre + k: v for k, v in b.items()}})
        out["shape"] = [n, rounds]
    out["bf16_over_f32"] = out["bf16_tops"] / out["tops"]
    return out


def turbo_inputs(c: int, n: int, win: int, seed: int, dev):
    """(u, v, a_init, b_init) of a half-iteration, boundaries pinned."""
    n_w = -(-n // win)
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)
    u = t(rng.standard_normal((c, n)) * 8.0)
    v = t(rng.standard_normal((c, n)) * 8.0)
    a0 = t(-np.abs(rng.standard_normal((c, n_w, 8))) * 4.0)
    b0 = t(-np.abs(rng.standard_normal((c, n_w, 8))) * 4.0)
    return (u, v, *turbo_mod._pin_boundaries(a0, b0))


def turbo_equal_plain(args, win: int, acq: int, *form) -> list[float]:
    """Kernel vs plain on (L, a_nii, b_nii), ``torch.equal``; ``form`` is
    (mdtype, pinpad), the f32 pinned form by default."""
    got = turbo_mod.half_iteration_raw(*args, win, acq, *form)
    ref = turbo_mod.half_iteration_plain(*args, win, acq, *form)
    torch.cuda.synchronize()
    errs = [max_abs_err(g, r) for g, r in zip(got, ref)]
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"turbo kernel {form} != plain (L, a_nii, "
                             f"b_nii) at {tuple(args[0].shape)}, win {win}, "
                             f"acq {acq}: max |err| {errs}")
    return errs


def check_turbo(cell: DlCell, dev) -> dict:
    """Half-iteration kernel vs plain at the main path's shape,
    C = 13 * 256 = 3328 codeblocks, K = 5824 (n = K+3 trellis steps), and
    at the ragged shapes."""
    for c, n, win, acq in TURBO_RAGGED:
        turbo_equal_plain(turbo_inputs(c, n, win, SEED + n, dev), win, acq)
    geom = cell.geom
    c, n, win, acq = geom.info.c * BATCH, geom.k + 3, 128, 16
    n_w = -(-n // win)
    u, v, a0, b0 = turbo_inputs(c, n, win, SEED + 1, dev)
    errs = turbo_equal_plain((u, v, a0, b0), win, acq)
    ms = cuda_time_ms(lambda: turbo_mod.half_iteration_raw(u, v, a0, b0,
                                                           win, acq), 20)
    plain_ms = cuda_time_ms(lambda: turbo_mod.half_iteration_plain(
        u, v, a0, b0, win, acq), 3)
    # bytes: u, v in and L out, the boundary metrics in and out; operations
    # per trellis position: 30 (alpha step) + 30 (beta step) + 39 (combine)
    # adds, maxes and halvings, plus the 2 * acq acquisition steps of each
    # window
    n_bytes = 4 * (3 * c * n + 4 * c * n_w * 8)
    ops = c * n * 99 + c * n_w * acq * 60
    return {"name": "turbo_half_iteration", "shape": [c, n, win, acq],
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, **bound(n_bytes, ops, F32_OPS_PER_S)}


# (name, mdtype, pinpad) of the turbo kernel's bf16 forms [bf16] checks
# ("bf16_f32store" runs the bf16 kernel: its stores hold the same values)
TURBO_FORMS = (("turbo_half_iteration_bf16", "bf16", True),
               ("turbo_half_iteration_bf16_freeze", "bf16", False))


def check_turbo_forms(cell: DlCell, dev) -> list[dict]:
    """The bf16 forms of the half-iteration kernel vs plain at the main
    path's shape (C = 3328, K = 5824, win 128) and at the ragged, SI and
    bf16-layout shapes, bit for bit, each timed on bf16 u, v (the wrapper's
    cast left out); then the bf16 kernel's variants (``BF16_VARIANTS``) and
    the f32 form, timed in turns at the main shape.  Bound: u, v and L move
    as bf16 (2 bytes), the inits and NII exports as f32; the alpha and beta
    stores stay in shared memory.  The 60 ACS operations of a position (and
    an acquisition step's 60) run in bf16 at the packed bf16 rate, the
    combine's 39 in f32."""
    geom = cell.geom
    c, n, win, acq = geom.info.c * BATCH, geom.k + 3, 128, 16
    n_w = -(-n // win)
    u, v, a0, b0 = turbo_inputs(c, n, win, SEED + 1, dev)
    ub, vb = u.to(torch.bfloat16), v.to(torch.bfloat16)
    bf16_ops = c * n * 60 + c * n_w * acq * 60
    f32_ops = c * n * 39
    eq_ops = f32_ops + bf16_ops * F32_OPS_PER_S / BF16X2_OPS_PER_S
    out = []
    for name, mdtype, pinpad in TURBO_FORMS:
        for cr, nr, wr, ar in TURBO_RAGGED + TURBO_SI + TURBO_BF16:
            turbo_equal_plain(turbo_inputs(cr, nr, wr, SEED + nr, dev), wr,
                              ar, mdtype, pinpad)
        errs = turbo_equal_plain((ub, vb, a0, b0), win, acq, mdtype, pinpad)
        ms = cuda_time_ms(lambda: turbo_mod.half_iteration_raw(
            ub, vb, a0, b0, win, acq, mdtype, pinpad), 20)
        plain_ms = cuda_time_ms(lambda: turbo_mod.half_iteration_plain(
            ub, vb, a0, b0, win, acq, mdtype, pinpad), 1)
        out.append({"name": name, "shape": [c, n, win, acq],
                    "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, "bf16_ops": bf16_ops,
                    "f32_ops": f32_ops,
                    **bound(2 * 3 * c * n + 4 * 4 * c * n_w * 8, eq_ops,
                            F32_OPS_PER_S)})
    out[0].update(time_turbo_variants((ub, vb, a0, b0), (u, v, a0, b0),
                                      win, acq))
    return out


def time_turbo_variants(args_bf16, args_f32, win: int, acq: int,
                        rounds: int = 3) -> dict:
    """The bf16 kernel's variants (pinned padding) and the f32 form on the
    same inputs, each held to its plain version bit for bit, then timed in
    turns (f32, 1, 2, 3, 3, 2, 1, f32, ...): the medians of
    ``rounds`` turns of 20 launches."""
    ref = turbo_mod.half_iteration_plain(*args_bf16, win, acq, "bf16")
    for var in turbo_mod.BF16_VARIANTS:
        got = turbo_mod.half_iteration_bf16_variant(*args_bf16, win, acq, var)
        torch.cuda.synchronize()
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"turbo bf16 variant {var} != plain")
    runs = {"f32": lambda: turbo_mod.half_iteration_raw(*args_f32, win, acq),
            **{var: (lambda vr=var: turbo_mod.half_iteration_bf16_variant(
                *args_bf16, win, acq, vr))
               for var in turbo_mod.BF16_VARIANTS}}
    times = {k: [] for k in runs}
    for r in range(rounds):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[k].append(cuda_time_ms(runs[k], 20))
    med = {k: float(np.median(t)) for k, t in times.items()}
    return {"variant_ms": {k: med[k] for k in turbo_mod.BF16_VARIANTS},
            "f32_same_run_ms": med["f32"]}


def check_turbo_mimo(dev) -> dict:
    """The half-iteration kernel vs plain at the TM3 MIMO decode's shape:
    C = 2 codewords * 13 * 256 = 6656 codeblocks, K = 5824; counted as
    :func:`check_turbo`."""
    geom = MIMO_TM3.geom
    c, n, win, acq = 2 * geom.info.c * BATCH, geom.k + 3, 128, 16
    n_w = -(-n // win)
    u, v, a0, b0 = turbo_inputs(c, n, win, SEED + 5, dev)
    errs = turbo_equal_plain((u, v, a0, b0), win, acq)
    ms = cuda_time_ms(lambda: turbo_mod.half_iteration_raw(u, v, a0, b0,
                                                           win, acq), 10)
    plain_ms = cuda_time_ms(lambda: turbo_mod.half_iteration_plain(
        u, v, a0, b0, win, acq), 1)
    return {"shape": [c, n, win, acq], "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms,
            **bound(4 * (3 * c * n + 4 * c * n_w * 8),
                    c * n * 99 + c * n_w * acq * 60, F32_OPS_PER_S)}


def check_turbo_si(dev) -> dict:
    """The half-iteration kernel vs plain at the SI path's shapes (C = 1,
    K 224 and 408, win 32, acq 16), timed at K 408; counted as
    :func:`check_turbo`.  Thirteen windows in four blocks of one warp:
    back-to-back calls time the wrapper's launch rate (``ms``), the
    profiler the kernel's own device time (``device_ms``)."""
    errs = []
    for c, n, win, acq in TURBO_SI:
        errs += turbo_equal_plain(turbo_inputs(c, n, win, SEED + n, dev), win,
                                  acq)
    c, n, win, acq = TURBO_SI[-1]
    n_w = -(-n // win)
    u, v, a0, b0 = turbo_inputs(c, n, win, SEED + 6, dev)
    ms = cuda_time_ms(lambda: turbo_mod.half_iteration_raw(u, v, a0, b0,
                                                           win, acq), 100)
    plain_ms = cuda_time_ms(lambda: turbo_mod.half_iteration_plain(
        u, v, a0, b0, win, acq), 3)
    dev_ms = device_ms(lambda: turbo_mod.half_iteration_raw(u, v, a0, b0,
                                                            win, acq), 20,
                       "turbo_half")
    return {"shape": [c, n, win, acq], "max_abs_err": max(errs), "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            **bound(4 * (3 * c * n + 4 * c * n_w * 8),
                    c * n * 99 + c * n_w * acq * 60, F32_OPS_PER_S)}


def _complex_noise(shape, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.as_tensor(x.astype(np.complex64), device=dev)


def check_resample() -> dict:
    """Resampler kernel vs plain, bit for bit, through
    ``resample_bench.run_shape`` at its three shapes: (16, 400 000) 192/125,
    sixteen captures of 20 ms at 20 Msps in one launch (the timed check;
    the scanner resamples one channel a launch), the scanner's own launch
    (1, 400 000) 192/125, and (1, 500 000) 768/625 (a 25 Msps capture).
    Device time warm (back-to-back launches) and cold (64 MB written between
    launches), each shape's bound (46 f32 operations an output, which do
    not fuse under -fmad=false; bytes decide), and the ``conv1d``
    yardstick: the reference's dense frame weight at stride Q on the real
    planes, cuDNN's TF32 off (``library_ms``) and on."""
    rows = []
    for k, shape in enumerate(resample_bench.SHAPES):
        r = resample_bench.run_shape(*shape, reps=50, seed=SEED + 2 + k)
        if not r["equal_plain"] or r["launches"] != 1:
            raise AssertionError(f"resample kernel != plain at {r['shape']}: "
                                 f"max |err| {r['max_abs_err']}, launches "
                                 f"{r['launches']}")
        rows.append({"shape": r["shape"], "max_abs_err": r["max_abs_err"],
                     "ms": r["warm_ms"], "cold_ms": r["cold_ms"],
                     "plain_ms": r["plain_ms"],
                     "library_ms": r["conv1d"]["f32_ms"],
                     "library_tf32_ms": r["conv1d"]["tf32_ms"],
                     **bound(r["bytes"], r["ops"], F32_OPS_PER_S)})
    return {**rows[0], "name": "resample_poly",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "library": "conv1d of the real planes, dense frame weight, "
                       "stride Q, TF32 off (library_tf32_ms: on)",
            "by_shape": rows}


def library_conv1d_ms(x: torch.Tensor, filt: np.ndarray,
                      tf32: bool) -> float:
    """The one PyTorch call nearest to the PSS correlator:
    ``torch.nn.functional.conv1d`` of the zero-padded complex streams with
    the conjugate replicas, in full f32 (``tf32`` False) or with cuDNN's
    TF32 allowed (True).  It gives the complex correlation of the same
    (C, 3, L) outputs and leaves out the kernel's |.|^2, so it is a
    yardstick that does a little less.  Used nowhere in the port."""
    w = torch.as_tensor(np.conj(filt), device=x.device)[:, None, :]
    xp = torch.nn.functional.pad(x, (0, filt.shape[1] - 1))[:, None, :]
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        y = torch.nn.functional.conv1d(xp, w)
        if y.shape != (x.shape[0], 3, x.shape[1]):
            raise AssertionError(f"conv1d yardstick shape {tuple(y.shape)}")
        del y
        return cuda_time_ms(lambda: torch.nn.functional.conv1d(xp, w), 3)
    finally:
        torch.backends.cudnn.allow_tf32 = before


def library_conv1d_bf16_ms(x: torch.Tensor, filt: np.ndarray) -> float:
    """``conv1d`` in bf16 (cuDNN on the tensor cores), the yardstick of the
    bf16 correlator: the complex correlation in real form, the streams'
    (re, im) as 2 input channels and each replica's real and imaginary
    output as 6 output channels (re: [h_re, h_im], im: [-h_im, h_re]
    against (x_re, x_im): x times conj(h)).  Leaves out the |.|^2, as
    :func:`library_conv1d_ms`.  cuDNN picks its algorithm by timing them
    (``cudnn.benchmark``).  Used nowhere in the port."""
    h = torch.as_tensor(filt, device=x.device)
    w = torch.stack([torch.stack([h.real, h.imag], 1),
                     torch.stack([-h.imag, h.real], 1)], 1).reshape(
        6, 2, -1).to(torch.bfloat16)
    xp = torch.nn.functional.pad(torch.stack([x.real, x.imag], 1),
                                 (0, filt.shape[1] - 1)).to(torch.bfloat16)
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        y = torch.nn.functional.conv1d(xp, w)
        if y.shape != (x.shape[0], 6, x.shape[1]):
            raise AssertionError(f"bf16 conv1d yardstick shape "
                                 f"{tuple(y.shape)}")
        del y
        return cuda_time_ms(lambda: torch.nn.functional.conv1d(xp, w), 3)
    finally:
        torch.backends.cudnn.benchmark = before


def check_pss(dev) -> list[dict]:
    """PSS correlator and detect kernels vs plain at 4 carriers x 20
    subframes of 20 MHz (nf = 2048): the f32 kernels bit for bit; the bf16
    kernels within ``pss.BF16_TOL`` of each carrier's peak magnitude, and
    exactly in the root and index of every carrier's peak."""
    filt = sync.pss_time_filters(SCAN_CFG)
    n_c, length = PSS_CHECK_SHAPE
    x = _complex_noise(PSS_CHECK_SHAPE, SEED + 3, dev)
    for c in range(n_c):
        x[c, 5000 + 7919 * c:5000 + 7919 * c + filt.shape[1]] += \
            30.0 * torch.as_tensor(filt[c % 3], device=dev)
    want = [5000 + 7919 * c for c in range(n_c)]
    tol = pss_mod.BF16_TOL
    # a complex multiply-add per (output, root, tap): 4 mul + 4 add, whatever
    # computes it (the Toeplitz form's extra chunk is not useful work); the
    # magnitude's 3 flop per output vanish beside them
    flop = x.numel() * 3 * filt.shape[1] * 8
    in_bytes = 8 * (x.numel() + filt.size)
    corr_bytes = in_bytes + 4 * 3 * x.numel()
    shape = list(PSS_CHECK_SHAPE)

    def found(parts, tile, name):
        nid2, idx, _, _ = pss_mod.pss_reduce_combine(*parts, tile, length)
        if nid2.tolist() != [c % 3 for c in range(n_c)] or \
                any(abs(i - w) > 2 for i, w in zip(idx.tolist(), want)):
            raise AssertionError(f"{name} found {nid2.tolist()} at "
                                 f"{idx.tolist()}, inserted at {want}")
        return nid2, idx

    out = []
    # -- f32: the direct correlator, bit for bit
    got = pss_mod.pss_corr_mag(x, filt, "f32")
    ref = pss_mod.pss_corr_mag_plain(x, filt, "f32")
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    if not torch.equal(got, ref):
        raise AssertionError(f"PSS correlator kernel != plain: max |err| "
                             f"{err}")
    peak_f32 = got.flatten(1).argmax(dim=1)
    del got, ref
    out.append({"name": "pss_corr_mag", "shape": shape, "max_abs_err": err,
                "ms": cuda_time_ms(
                    lambda: pss_mod.pss_corr_mag(x, filt, "f32"), 5),
                "plain_ms": cuda_time_ms(
                    lambda: pss_mod.pss_corr_mag_plain(x, filt, "f32"), 1, 0),
                "library_ms": library_conv1d_ms(x, filt, tf32=False),
                "library": "conv1d, f32, TF32 off",
                # built with -fmad=false: each flop is an instruction, at
                # the add/mul rate, not the FMA-counted flop rate
                "bound_nofma_ms": max(corr_bytes / HBM_BYTES_PER_S,
                                      flop / F32_OPS_PER_S) * 1e3,
                **bound(corr_bytes, flop, F32_FLOP_PER_S)})
    got = pss_mod.pss_detect(x, filt, "f32")[:3]
    ref = pss_mod.pss_detect_plain(x, filt, "f32")
    torch.cuda.synchronize()
    errs = [max_abs_err(g, r) for g, r in zip(got, ref)]
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"PSS detect kernel != plain (max, argmax, "
                             f"sum): max |err| {errs}")
    found(got, pss_mod.TILE, "PSS detect (f32)")
    out.append({"name": "pss_detect", "shape": shape,
                "max_abs_err": max(errs),
                "ms": cuda_time_ms(
                    lambda: pss_mod.pss_detect(x, filt, "f32"), 5),
                "plain_ms": cuda_time_ms(
                    lambda: pss_mod.pss_detect_plain(x, filt, "f32"), 1, 0),
                "library_ms": None,
                **bound(in_bytes + sum(4 * g.numel() for g in got), flop,
                        F32_FLOP_PER_S)})

    # -- bf16: the Toeplitz GEMM on the tensor cores, by tolerance
    got = pss_mod.pss_corr_mag(x, filt)
    ref = pss_mod.pss_corr_mag_plain(x, filt)
    torch.cuda.synchronize()
    peak = ref.amax(dim=(1, 2))
    rel = ((got - ref).abs().amax(dim=(1, 2)) / peak).tolist()
    err = max_abs_err(got, ref)
    peak_got = got.flatten(1).argmax(dim=1)
    if max(rel) > tol or not torch.equal(peak_got,
                                         ref.flatten(1).argmax(dim=1)):
        raise AssertionError(f"PSS bf16 correlator vs plain: |err| / peak "
                             f"per carrier {rel} (limit {tol}), or another "
                             f"root or index")
    moved = int((peak_got != peak_f32).sum())
    del got
    # the yardstick is the faster of two single calls: conv1d in bf16, or
    # in f32 with cuDNN's TF32 on
    lib = {"conv1d, bf16 (real form, 2 -> 6 channels)":
           library_conv1d_bf16_ms(x, filt),
           "conv1d, f32 with cuDNN TF32 on":
           library_conv1d_ms(x, filt, tf32=True)}
    lib_name = min(lib, key=lib.get)
    out.append({"name": "pss_corr_mag_bf16", "shape": shape,
                "max_abs_err": err, "max_rel_err_of_peak": max(rel),
                "tolerance_of_peak": tol, "peaks_moved_vs_f32": moved,
                "ms": cuda_time_ms(lambda: pss_mod.pss_corr_mag(x, filt), 10),
                "plain_ms": cuda_time_ms(
                    lambda: pss_mod.pss_corr_mag_plain(x, filt), 1, 0),
                "library_ms": lib[lib_name], "library": lib_name,
                "library_bf16_ms": lib["conv1d, bf16 (real form, 2 -> 6 "
                                       "channels)"],
                "library_tf32_ms": lib["conv1d, f32 with cuDNN TF32 on"],
                **bound(corr_bytes, flop, BF16_TENSOR_FLOP_PER_S)})
    got = pss_mod.pss_detect(x, filt)[:3]
    rp = pss_mod.pss_detect_plain(x, filt)
    torch.cuda.synchronize()
    max_rel = float((got[0] - rp[0]).abs().max() / peak.max())
    sum_rel = float(((got[2] - rp[2]).abs() / rp[2]).max())
    a = found(got, pss_mod.TILE_BF16, "PSS detect (bf16)")
    b = found(rp, pss_mod.TILE_BF16, "PSS detect plain (bf16)")
    # the per-tile sum adds 16 384 non-negative magnitudes in f32 in another
    # order: relative rounding ~1e-7 * sqrt(terms), held to the same limit
    if max_rel > tol or sum_rel > tol or not all(
            torch.equal(g, r) for g, r in zip(a, b)):
        raise AssertionError(f"PSS bf16 detect vs plain: tile max off by "
                             f"{max_rel} of the peak, tile sum by {sum_rel} "
                             f"(limit {tol}), combine {a} vs {b}")
    out.append({"name": "pss_detect_bf16", "shape": shape,
                "max_abs_err": max_abs_err(got[0], rp[0]),
                "max_rel_err_of_peak": max_rel, "sum_rel_err": sum_rel,
                "tolerance_of_peak": tol,
                "ms": cuda_time_ms(lambda: pss_mod.pss_detect(x, filt), 10),
                "plain_ms": cuda_time_ms(
                    lambda: pss_mod.pss_detect_plain(x, filt), 1, 0),
                "library_ms": None,
                **bound(in_bytes + sum(4 * g.numel() for g in got), flop,
                        BF16_TENSOR_FLOP_PER_S)})
    return out


def scanner_captures() -> tuple[list, list]:
    """16 channels of 20 ms at 20 Msps (seed 0), written under ``WORK``:
    12 live cells (distinct ids covering n_id_2 0/1/2; n_ant 1 on 6, 2 on
    4, 4 on 2; CFO uniform in +-5 kHz; SNR 10-20 dB; start offset uniform
    in [0, 10 ms); a different start SFN each) and 4 dead channels (AWGN
    only).  Returns (channels, expected captures or None when dead)."""
    rng = np.random.default_rng(SEED)
    WORK.mkdir(parents=True, exist_ok=True)
    ids = [int(3 * n1 + k % 3)
           for k, n1 in enumerate(rng.choice(168, N_LIVE, replace=False))]
    ants = [1] * 6 + [2] * 4 + [4] * 2
    sfns = rng.choice(1024, N_LIVE, replace=False)
    nsf10 = 10 * SCAN_CFG.n_samps_subframe
    chans, caps = [], []
    for k in range(N_LIVE + N_DEAD):
        path = WORK / f"ch{k:02d}.fc32"
        if k < N_LIVE:
            cell = cell_gen.Cell(n_rb_dl=100, n_cell_id=ids[k],
                                 n_ant=ants[k],
                                 phich_resource=(0.5, 1.0, 2.0)[k % 3])
            cap = cell_gen.capture(
                cell, SCAN_S, sfn0=int(sfns[k]),
                offset=int(rng.integers(0, nsf10)),
                cfo_hz=float(rng.uniform(-5e3, 5e3)),
                snr_db=float(rng.uniform(10.0, 20.0)), rate_hz=SDR_RATE,
                seed=SEED + k, device="cuda")
            write_iq(str(path), cap.iq)
            caps.append((cell, cap))
        else:
            n = int(SCAN_S * SDR_RATE)
            write_iq(str(path), (rng.standard_normal(n) + 1j
                                 * rng.standard_normal(n)) * 0.05)
            caps.append(None)
        chans.append(scanner.Channel(str(3000 + k), str(path),
                                     rate_hz=SDR_RATE))
    return chans, caps


def _as_json(msg) -> dict:
    """A message dataclass as the scan report serialises it."""
    return json.loads(json.dumps(dataclasses.asdict(msg)))


def check_scan_reports(reports: list, caps: list, all_si: bool = False
                       ) -> None:
    """Each live channel reports the cell id, n_ant and MIB it was made
    with, no SI CRC failure, every SIB it reports equal to the one sent,
    and at least the SIB of its first whole frame's subframe 5 (SIB1 in an
    even frame, SIB2 in an odd one) — with ``all_si``, SIB1, SIB2 and the
    paging sent.  Each dead channel reports nothing."""
    for d, c in zip(reports, caps):
        if c is None:
            if d.get("mib") is not None or \
                    d.get("prescan", {}).get("detected", True):
                raise AssertionError(f"dead channel {d['channel']} "
                                     f"reported a cell: {d}")
            continue
        cell, cap = c
        mib = d.get("mib") or {}
        got = (d.get("n_cell_id"), d.get("n_ant"), mib.get("n_rb_dl"),
               mib.get("phich_resource"), mib.get("sfn"))
        want = (cell.n_cell_id, cell.n_ant, cell.n_rb_dl,
                cell.phich_resource, cap.sfn)
        if got != want:
            raise AssertionError(f"channel {d['channel']}: reported "
                                 f"(cell, n_ant, n_rb, phich, sfn) {got}, "
                                 f"sent {want}")
        sent = {"sib1": _as_json(cell.sib1()), "sib2": _as_json(cell.sib2())}
        need = ("sib1", "sib2") if all_si else \
            ("sib1" if cap.sfn % 2 == 0 else "sib2",)
        paging = [hex(x) for x in cell.paging_tmsi] or None
        if d.get("sib_crc_fails") != 0 or \
                any(d.get(k) is None for k in need) or \
                any(d.get(k) not in (None, sent[k]) for k in sent) or \
                (all_si and d.get("paging") != paging):
            raise AssertionError(
                f"channel {d['channel']}: SI {d.get('sib1')}, "
                f"{d.get('sib2')}, paging {d.get('paging')}, CRC failures "
                f"{d.get('sib_crc_fails')}; sent {sent}, paging {paging}")


def scan_card_vs_cpu(chan, dev, card: str) -> dict:
    """One capture scanned on the card and on the CPU (plain versions)."""
    x = torch.from_numpy(read_iq(chan.path))
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        xn = poly_mod.resample_poly(x.to(d), 192, 125)
        t0 = time.perf_counter()
        res[name] = file_scan.scan(xn, SCAN_CFG, max_si_subframes=0)
        res[name + "_s"] = time.perf_counter() - t0
    g, c = res["card"], res["cpu"]
    for f in ("n_cell_id", "frame_start", "n_ant", "sfn", "mib"):
        if getattr(g, f) != getattr(c, f):
            raise AssertionError(f"card vs CPU scan: {f} {getattr(g, f)} "
                                 f"!= {getattr(c, f)}")
    diffs = {"cfo_hz": abs(g.cfo_hz - c.cfo_hz),
             "rsrp_db": abs(g.rsrp_dbfs - c.rsrp_dbfs),
             "snr_db": abs(g.snr_db - c.snr_db),
             "evm_pct": abs(g.evm_pct - c.evm_pct)}
    if diffs["cfo_hz"] > 1.0 or diffs["rsrp_db"] > 0.1 or \
            diffs["snr_db"] > 0.1:
        raise AssertionError(f"card vs CPU scan differ: {diffs}")
    print(f"[scan-cpu-vs-card] channel {chan.label}: integers and MIB "
          f"equal; |diff| {diffs}; card {res['card_s']:.3f} s, CPU "
          f"{res['cpu_s']:.3f} s ({card})")
    return diffs


def find_pss_f32(chan, dev) -> dict:
    """``sync.find_pss`` on one capture in f32 (the direct correlator, the
    reference's study mode) and in the default: the same root, the index
    within one sample (the lobe's top is flat below the noise)."""
    x = poly_mod.resample_poly(torch.from_numpy(read_iq(chan.path)).to(dev),
                               192, 125)
    pss_mod.CORR_LAUNCHES = 0
    nid2, idx, _ = sync.find_pss(x, SCAN_CFG, mdtype="f32")
    torch.cuda.synchronize()
    launches = pss_mod.CORR_LAUNCHES
    nid2_d, idx_d, _ = sync.find_pss(x, SCAN_CFG)
    moved = int(idx) - int(idx_d)
    print(f"[find-pss-f32] channel {chan.label}: root {int(nid2)} at "
          f"{int(idx)} in f32, root {int(nid2_d)} at {int(idx_d)} in bf16; "
          f"launches {launches}")
    if int(nid2) != int(nid2_d) or abs(moved) > 1 or launches <= 0:
        raise AssertionError("find_pss in f32 and in bf16 disagree, or the "
                             "f32 correlator was not launched")
    return {"launches": launches, "idx_moved": moved}


def run_scanner(dev, card: str) -> dict:
    """The scanner path: 16 channels through scan_channels(prescan=True),
    twice (run 0 warms caches, run 1 is reported), each run with its own
    launch counts, and each must report the cells that were sent.  Then
    the f32 correlator through ``find_pss`` on one capture."""
    t0 = time.perf_counter()
    poly_mod.LAUNCHES = 0
    chans, caps = scanner_captures()
    gen_k6 = poly_mod.LAUNCHES
    print(f"[scan-gen] {len(chans)} captures of {SCAN_S * 1e3:.0f} ms at "
          f"{SDR_RATE / 1e6:.0f} Msps: {time.perf_counter() - t0:.2f} s; "
          f"resample_poly launches {gen_k6} (one a live capture, resampled "
          f"on the card)")
    if gen_k6 != N_LIVE:
        raise AssertionError(f"the scanner's captures launched "
                             f"resample_poly {gen_k6} times, not {N_LIVE}")
    runs = [scan_counted(tag, chans, caps, dev, card)
            for tag in ("first", "second")]
    f32 = find_pss_f32(chans[0], dev)
    diffs = scan_card_vs_cpu(chans[0], dev, card)
    si = si_cost(chans, caps, dev, card)
    return {"wall_s": runs[1]["wall_s"], "stages": runs[1]["stages"],
            "reads": runs[1]["reads"],
            "launches": {**runs[1]["launches"],
                         "pss_corr_mag": f32["launches"]},
            "turbo_launches": runs[1]["turbo_launches"],
            "demap_launches": runs[1]["demap_launches"],
            "first_wall_s": runs[0]["wall_s"],
            "find_pss_f32_idx_moved": f32["idx_moved"], "cpu_vs_card": diffs,
            "si_cost": si, "capture_launches": gen_k6,
            "chans": chans, "caps": caps}


def scan_counted(tag: str, chans: list, caps: list, dev, card: str,
                 all_si: bool = False) -> dict:
    """One run of ``scan_channels(prescan=True)`` with the counts set to 0
    just before it and read just after, its reports checked."""
    scanner.STAGE_SECONDS.clear()
    host.READS = 0
    poly_mod.LAUNCHES = turbo_mod.LAUNCHES = demap_mod.LAUNCHES = 0
    pss_mod.CORR_LAUNCHES = pss_mod.CORR_BF16_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reports = scanner.scan_channels(chans, SCAN_CFG, prescan=True,
                                    device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"resample_poly": poly_mod.LAUNCHES,
                "pss_corr_mag_bf16": pss_mod.CORR_BF16_LAUNCHES}
    turbo, demap = turbo_mod.LAUNCHES, demap_mod.LAUNCHES
    check_scan_reports(reports, caps, all_si)
    for name, cnt in {**launches, "turbo_half_iteration": turbo}.items():
        if cnt <= 0:
            raise AssertionError(f"the scanner path never launched {name}")
    if pss_mod.CORR_LAUNCHES:
        raise AssertionError("the scanner path launched the f32 "
                             "correlator: bf16 is its default")
    if demap:
        raise AssertionError(f"the scanner path launched the demap kernel "
                             f"{demap} times: its SI stage demaps each RE "
                             f"set in plain torch, as the reference does")
    n = len(chans)
    n_live = sum(c is not None for c in caps)
    st = dict(scanner.STAGE_SECONDS)
    sibs = sum((d.get("sib1") is not None) + (d.get("sib2") is not None)
               for d in reports)
    print(f"[{'si' if all_si else 'scanner'}] {tag} run: {n_live}/{n_live} "
          f"live cells with the sent id, n_ant, MIB and SIBs ({sibs} SIBs"
          f"{', paging' if all_si else ''}), {n - n_live}/{n - n_live} dead "
          f"flagged; wall {wall * 1e3 / n:.2f} ms per channel (resample "
          f"{st.get('resample', 0) * 1e3 / n:.2f}, prescan "
          f"{st.get('prescan', 0) * 1e3 / n:.2f}, scan "
          f"{st.get('scan', 0) * 1e3 / n_live:.2f} per live channel); host "
          f"reads {host.READS} ({host.READS / n_live:.2f} per live channel); "
          f"launches {launches}, turbo_half_iteration {turbo} "
          f"({turbo / n_live:.1f} per live scan) ({card})")
    return {"tag": tag, "wall_s": wall, "stages": st, "reads": host.READS,
            "launches": launches, "turbo_launches": turbo,
            "demap_launches": demap, "reports": reports}


def si_cost(chans: list, caps: list, dev, card: str) -> dict:
    """Each live capture, resampled on the card, scanned without the SI
    stage (``max_si_subframes=0``) and with it, in turns, three times:
    median ms per live channel of each and their difference."""
    xs = [poly_mod.resample_poly(torch.from_numpy(read_iq(ch.path)).to(dev),
                                 192, 125)
          for ch, c in zip(chans, caps) if c is not None]
    times = {0: [], 64: []}
    for _ in range(3):
        for x in xs:
            for m in (0, 64):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                file_scan.scan(x, SCAN_CFG, max_si_subframes=m)
                torch.cuda.synchronize()
                times[m].append(time.perf_counter() - t0)
    no_si, with_si = (float(np.median(times[m])) * 1e3 for m in (0, 64))
    print(f"[scanner] scan per live channel (median of {len(times[0])}, in "
          f"turns): without SI {no_si:.2f} ms, with SI {with_si:.2f} ms, SI "
          f"stage {with_si - no_si:.2f} ms ({card})")
    return {"no_si_ms": no_si, "with_si_ms": with_si,
            "si_ms": with_si - no_si}


def run_sweep(dev, card: str) -> dict:
    """The band sweep: 128 carriers x 20 subframes through the detect
    kernel, in bf16 (the default) and in f32.  Every carrier must give root
    1, and the same index as the plain version of the same arithmetic on
    the same samples, within the PSS correlation's main lobe (+-8 of
    2048/62 = 33 samples) of the inserted PSS start: at the reference
    synthesis's noise level the lobe's top is flat to ~0.3% per sample,
    below the noise, so the exact sample is the noise's choice (and may
    move by one between the two arithmetics)."""
    length = SWEEP_SF * SCAN_CFG.n_samps_subframe
    t0 = time.perf_counter()
    x_np, want = scan_throughput.sweep_signal(SCAN_CFG, SWEEP_CARRIERS,
                                              length, seed=SEED)
    x = torch.from_numpy(x_np).to(dev)
    del x_np
    print(f"[sweep-gen] {SWEEP_CARRIERS} x {length} samples "
          f"({x.numel() * 8 / 1e6:.0f} MB): {time.perf_counter() - t0:.2f} s")
    filt = sync.pss_time_filters(SCAN_CFG)
    res = {}
    for mdtype in pss_mod.MDTYPES:
        pss_mod.DETECT_LAUNCHES = pss_mod.DETECT_BF16_LAUNCHES = 0
        nid2, idx, _ = scan_throughput.detect(x, SCAN_CFG, mdtype)
        nid2, idx = nid2.tolist(), idx.tolist()
        launches = (pss_mod.DETECT_BF16_LAUNCHES if mdtype == "bf16"
                    else pss_mod.DETECT_LAUNCHES)
        ref_idx = []
        for c0 in range(0, SWEEP_CARRIERS, 16):
            parts = pss_mod.pss_detect_plain(x[c0:c0 + 16], filt, mdtype)
            ref_idx += pss_mod.pss_reduce_combine(
                *parts, pss_mod.detect_tile(mdtype), length)[1].tolist()
        dev_from_sent = [i - int(w) for i, w in zip(idx, want)]
        bad = [c for c in range(SWEEP_CARRIERS)
               if nid2[c] != 1 or idx[c] != ref_idx[c]
               or abs(dev_from_sent[c]) > 8]
        if bad or launches <= 0:
            raise AssertionError(f"sweep ({mdtype}): carriers {bad} wrong "
                                 f"(launches {launches})")
        times = []
        for _ in range(SWEEP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scan_throughput.detect(x, SCAN_CFG, mdtype)[2].cpu()
            times.append(time.perf_counter() - t0)
        t = float(np.median(times))
        msps = SWEEP_CARRIERS * length / t / 1e6
        exact = sum(d == 0 for d in dev_from_sent)
        off = {c: d for c, d in enumerate(dev_from_sent) if d}
        print(f"[sweep] {mdtype}: {SWEEP_CARRIERS} carriers x {SWEEP_SF} sf: "
              f"all root 1, index equal to the plain version's on all; "
              f"{exact} exactly at the inserted PSS start, the rest "
              f"(carrier: samples off) {off}; median {t * 1e3:.2f} ms per "
              f"sweep (n={len(times)}) = {msps:.1f} Msps ({card})")
        res[mdtype] = {"median_ms": t * 1e3, "msps": msps,
                       "launches": launches, "exact_idx": exact, "idx": idx}
    moved = sum(a != b for a, b in zip(res["bf16"]["idx"], res["f32"]["idx"]))
    print(f"[sweep] carriers whose peak index differs between the bf16 and "
          f"the f32 kernel: {moved} of {SWEEP_CARRIERS}")
    for r in res.values():
        del r["idx"]
    return {**res["bf16"], "f32": res["f32"], "moved_vs_f32": moved}


def decode_counted(name: str, dec, x: torch.Tensor, tb_ref: np.ndarray,
                   want_ok: int | None) -> dict:
    """One decode with the demap and turbo launch counts set to 0 just
    before it and read just after; ``want_ok`` transport blocks must pass
    their CRC (``None``: any number), and every one that passes must carry
    the bits sent."""
    torch.cuda.reset_peak_memory_stats()
    demap_mod.LAUNCHES = 0
    turbo_mod.LAUNCHES = 0
    bits, ok, n_iter = dec(x)
    torch.cuda.synchronize()
    launches = {"demap": demap_mod.LAUNCHES,
                "turbo_half_iteration": turbo_mod.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = dec.last_stats
    n_ok, n = int(ok.sum()), len(tb_ref)
    okn = ok.cpu().numpy()
    bits_ok = bool(np.array_equal(bits.cpu().numpy()[okn], tb_ref[okn]))
    print(f"[{name}] crc ok {n_ok}/{n}, bits of those equal sent: {bits_ok}, "
          f"n_iter {n_iter}/{dec.n_iter}, host syncs {stats.syncs}, "
          f"compacted retries {stats.retries}, launches {launches}")
    if bits.shape != tb_ref.shape or bits.dtype != torch.int8:
        raise AssertionError(f"{name}: tb_bits {tuple(bits.shape)} "
                             f"{bits.dtype}")
    if (want_ok is not None and n_ok != want_ok) or not bits_ok:
        raise AssertionError(f"{name}: {n_ok}/{n} transport blocks decoded, "
                             f"{want_ok} expected (bits equal: {bits_ok})")
    for kernel, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"the {name} path never launched {kernel}")
    return {"launches": launches, "n_iter": n_iter, "syncs": stats.syncs,
            "retries": stats.retries, "peak_gb": peak_gb, "n_ok": n_ok}


def _llrs(front_out) -> list:
    """The LLR tensors a decoder's front hands on (the SIC front: CW0's
    de-matched and CW1's MMSE LLRs)."""
    if torch.is_tensor(front_out):
        return [front_out]
    return [front_out.d0, front_out.llr1]


def card_vs_cpu(name: str, dec, dec_cpu, x_small: torch.Tensor) -> None:
    """The card's decode of a small slice equals the CPU's (plain
    versions): bits, CRC flags and n_iter equal, the front's LLRs within
    1e-4 of the largest (FFT rounding)."""
    d_gpu, d_cpu = dec.front(x_small), dec_cpu.front(x_small.cpu())
    out_gpu, out_cpu = dec.turbo(d_gpu), dec_cpu.turbo(d_cpu)
    diffs = [(max_abs_err(g.cpu(), c), float(c.abs().max()))
             for g, c in zip(_llrs(d_gpu), _llrs(d_cpu))]
    print(f"[{name}-cpu-vs-card] {out_cpu[0].shape[0]} transport blocks: "
          f"front LLR max |diff| " + ", ".join(
              f"{e:.3e} (max |LLR| {m:.1f})" for e, m in diffs)
          + f"; n_iter {out_gpu[2]} vs {out_cpu[2]}")
    if not (torch.equal(out_gpu[0].cpu(), out_cpu[0])
            and torch.equal(out_gpu[1].cpu(), out_cpu[1])
            and out_gpu[2] == out_cpu[2]):
        raise AssertionError(f"{name}: card and CPU decodes of the same "
                             f"slice differ")
    if any(e > 1e-4 * m for e, m in diffs):
        raise AssertionError(f"{name}: card and CPU fronts differ beyond "
                             f"FFT rounding")


def run_dl(cell: DlCell, dev, card: str) -> dict:
    """The DL path: 256 subframes of the bench.py headline config."""
    t0 = time.perf_counter()
    iq, tb_ref = dl_subframes(cell, BATCH, SNR_DB, seed=SEED)
    print(f"[gen] {BATCH} subframes, TBS {cell.geom.tbs}, C={cell.geom.info.c}"
          f", K={cell.geom.k}, {SNR_DB} dB: {time.perf_counter() - t0:.2f} s")
    dec = make_batch_decoder(*cell.decoder_args(), device=dev)
    x = torch.from_numpy(iq).to(dev)
    out = decode_counted("decode", dec, x, tb_ref, BATCH)
    card_vs_cpu("decode", dec,
                make_batch_decoder(*cell.decoder_args(), device="cpu"), x[:4])
    torch.cuda.reset_peak_memory_stats()
    dec.front(x)
    torch.cuda.synchronize()
    front_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t_med, t_p90 = time_decode(dec, x, DECODE_REPS)
    decode_gb = torch.cuda.max_memory_allocated() / 1e9
    mbps = BATCH * cell.geom.tbs / t_med / 1e6
    print(f"[timing] decode B={BATCH}: median {t_med * 1e3:.3f} ms/batch, "
          f"p90 {t_p90 * 1e3:.3f} (n={DECODE_REPS}), {mbps:.2f} Mbit/s "
          f"({card})")
    print(f"[memory] peak allocated: first decode {out['peak_gb']:.2f} GB, "
          f"front {front_gb:.2f} GB, steady decode {decode_gb:.2f} GB "
          f"({card})")
    front_ms = cuda_time_ms(lambda: dec.front(x), 5)
    print(f"[timing] front (OFDM..de-match) {front_ms:.3f} ms/batch ({card})")
    return {**out, "decode_ms": t_med * 1e3, "decode_p90_ms": t_p90 * 1e3,
            "mbit_per_s": mbps, "peak_gb": decode_gb, "front_ms": front_ms}


def run_ul(cell: UlCell, dev, card: str) -> dict:
    """The UL-SCH path: 256 gridded subframes at 100 PRB / TBS 75376."""
    geom = cell.alloc.geom
    t0 = time.perf_counter()
    iq, tb_ref = ul_subframes(cell, BATCH, SNR_DB, seed=SEED)
    print(f"[ul-gen] {BATCH} subframes, {cell.alloc.n_prb} PRB, TBS "
          f"{geom.tbs}, C={geom.info.c}, K={geom.k}, {cell.alloc.scheme}, "
          f"{SNR_DB} dB: {time.perf_counter() - t0:.2f} s")
    dec = make_pusch_batch_decoder(*cell.decoder_args(), device=dev)
    x = torch.from_numpy(iq).to(dev)
    out = decode_counted("ul", dec, x, tb_ref, BATCH)
    card_vs_cpu("ul", dec,
                make_pusch_batch_decoder(*cell.decoder_args(), device="cpu"),
                x[:4])
    torch.cuda.reset_peak_memory_stats()
    t_med, t_p90 = time_decode(dec, x, UL_REPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mbps = BATCH * geom.tbs / t_med / 1e6
    front_ms = cuda_time_ms(lambda: dec.front(x), 5)
    print(f"[ul] decode B={BATCH}: median {t_med * 1e3:.3f} ms/batch, p90 "
          f"{t_p90 * 1e3:.3f} (n={UL_REPS}), {mbps:.2f} Mbit/s; front (LS.."
          f"de-match) {front_ms:.3f} ms/batch; peak allocated {peak_gb:.2f} "
          f"GB ({card})")
    return {**out, "decode_ms": t_med * 1e3, "decode_p90_ms": t_p90 * 1e3,
            "mbit_per_s": mbps, "front_ms": front_ms, "peak_gb": peak_gb}


def run_harq(cell: DlCell, dev, card: str) -> dict:
    """The HARQ-IR path: rv 0 + rv 2 of 64 transport blocks at
    ``HARQ_SNR_DB``, where rv 0 alone must decode none and the combination
    all; then both decoders timed at 25 dB."""
    t0 = time.perf_counter()
    iq, tb_ref, cells = harq_transmissions(
        cell, HARQ_SUBFRAMES, HARQ_RVS, HARQ_BATCH, HARQ_SNR_DB, seed=SEED)
    iq_hi, tb_hi, _ = harq_transmissions(
        cell, HARQ_SUBFRAMES, HARQ_RVS, HARQ_BATCH, SNR_DB, seed=SEED + 1)
    print(f"[harq-gen] 2 x {len(cells)} x {HARQ_BATCH} subframes, subframes "
          f"{HARQ_SUBFRAMES}, rv {HARQ_RVS}, {HARQ_SNR_DB} and {SNR_DB} dB: "
          f"{time.perf_counter() - t0:.2f} s")
    dec_h = make_batch_harq_decoder(*harq_decoder_args(cells), device=dev)
    dec_1 = make_batch_decoder(*cells[0].decoder_args(), device=dev)
    x = torch.from_numpy(iq).to(dev)
    out = decode_counted(f"harq rv0+rv2 {HARQ_SNR_DB} dB", dec_h, x, tb_ref,
                         HARQ_BATCH)
    decode_counted(f"harq rv0 alone {HARQ_SNR_DB} dB", dec_1, x[0], tb_ref, 0)
    card_vs_cpu("harq", dec_h, make_batch_harq_decoder(
        *harq_decoder_args(cells), device="cpu"), x[:, :4])
    x_hi = torch.from_numpy(iq_hi).to(dev)
    decode_counted(f"harq rv0+rv2 {SNR_DB} dB", dec_h, x_hi, tb_hi,
                   HARQ_BATCH)
    decode_counted(f"harq rv0 alone {SNR_DB} dB", dec_1, x_hi[0], tb_hi,
                   HARQ_BATCH)
    # in turns, so that a change in the host's load meets both alike
    pairs = [(time_decode(dec_h, x_hi, 1)[0],
              time_decode(dec_1, x_hi[0], 1)[0]) for _ in range(HARQ_REPS)]
    t_h, t_1 = (float(np.median(t)) for t in zip(*pairs))
    print(f"[harq] B={HARQ_BATCH}, {SNR_DB} dB: combined median "
          f"{t_h * 1e3:.3f} ms/batch, rv 0 alone {t_1 * 1e3:.3f} (n="
          f"{HARQ_REPS} each, in turns), ratio {t_h / t_1:.3f} ({card})")
    f_h = cuda_time_ms(lambda: dec_h.front(x_hi), 5)
    f_1 = cuda_time_ms(lambda: dec_1.front(x_hi[0]), 5)
    print(f"[harq] fronts by CUDA events: two summed {f_h:.3f} ms/batch, "
          f"one {f_1:.3f} ({card})")
    return {**out, "snr_db": HARQ_SNR_DB, "combined_ms": t_h * 1e3,
            "single_ms": t_1 * 1e3, "ratio": t_h / t_1,
            "combined_front_ms": f_h, "single_front_ms": f_1}


def reencode_ms(k: int, n: int, dev) -> float:
    """The re-encode of n random codeblocks of K bits, checked exact on 64
    of them against the numpy encoder, timed by CUDA events."""
    bits = torch.as_tensor(np.random.default_rng(SEED + k).integers(
        0, 2, (n, k)).astype(np.int8), device=dev)
    got = turbo_reencode_batch(bits, k)
    if not np.array_equal(got[:64].cpu().numpy(),
                          turbo_encode(bits[:64].cpu().numpy(), k)):
        raise AssertionError(f"re-encode at ({n}, {k}) != turbo_encode")
    return cuda_time_ms(lambda: turbo_reencode_batch(bits, k), 5)


def run_mimo(dev, card: str) -> dict:
    """The 2x2 MIMO paths: TM3 MMSE at the bench defaults (B=256), then the
    tracked TM4 configuration (B=192) through MMSE and SIC on one IQ."""
    t0 = time.perf_counter()
    iq, tb = mimo_subframes(MIMO_TM3, BATCH, SNR_DB, "bench", seed=SEED)
    g3 = MIMO_TM3.geom
    print(f"[mimo-gen] TM3, {BATCH} subframes x 2 codewords, TBS {g3.tbs}, "
          f"C={g3.info.c}, K={g3.k}, channel bench, {SNR_DB} dB: "
          f"{time.perf_counter() - t0:.2f} s")
    dec = make_mimo_batch_decoder(*MIMO_TM3.decoder_args(), device=dev)
    x = torch.from_numpy(iq).to(dev)
    del iq
    out = decode_counted("mimo tm3", dec, x, decoder_rows(tb), 2 * BATCH)
    card_vs_cpu("mimo", dec, make_mimo_batch_decoder(
        *MIMO_TM3.decoder_args(), device="cpu"), x[:, :4])
    torch.cuda.reset_peak_memory_stats()
    t_med, t_p90 = time_decode(dec, x, MIMO_REPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    front_ms = cuda_time_ms(lambda: dec.front(x), 5)
    mbps = 2 * BATCH * g3.tbs / t_med / 1e6
    print(f"[mimo] TM3 MMSE B={BATCH}: median {t_med * 1e3:.3f} ms/batch, "
          f"p90 {t_p90 * 1e3:.3f} (n={MIMO_REPS}), {mbps:.2f} Mbit/s; front "
          f"{front_ms:.3f} ms; peak allocated {out['peak_gb']:.2f} GB first, "
          f"{peak_gb:.2f} steady ({card})")
    tm3 = {**out, "decode_ms": t_med * 1e3, "decode_p90_ms": t_p90 * 1e3,
           "mbit_per_s": mbps, "front_ms": front_ms, "peak_gb": peak_gb,
           "reencode_ms": reencode_ms(g3.k, BATCH * g3.info.c, dev)}
    del x, dec

    t0 = time.perf_counter()
    iq, tb = mimo_subframes(MIMO_TM4, MIMO_TM4_BATCH, MIMO_TM4_SNR_DB, "corr",
                            seed=SEED)
    g4, rows = MIMO_TM4.geom, decoder_rows(tb)
    print(f"[mimo-gen] TM4 cb 0, {MIMO_TM4_BATCH} subframes, TBS {g4.tbs}, "
          f"C={g4.info.c}, K={g4.k}, channel corr, {MIMO_TM4_SNR_DB} dB: "
          f"{time.perf_counter() - t0:.2f} s")
    x = torch.from_numpy(iq).to(dev)
    del iq
    args = MIMO_TM4.decoder_args()
    dec_m = make_mimo_batch_decoder(*args, **MIMO_TM4.precoding, device=dev)
    sic = DecoderTuning(mimo_detector="sic")
    dec_s = make_mimo_batch_decoder(*args, **MIMO_TM4.precoding, tuning=sic,
                                    device=dev)
    mm = decode_counted("mimo tm4 mmse", dec_m, x, rows, None)
    sc = decode_counted("mimo tm4 sic", dec_s, x, rows, 2 * MIMO_TM4_BATCH)
    if sc["n_ok"] < mm["n_ok"]:
        raise AssertionError(f"SIC decoded {sc['n_ok']}, MMSE {mm['n_ok']}")
    card_vs_cpu("mimo-sic", dec_s, make_mimo_batch_decoder(
        *args, **MIMO_TM4.precoding, tuning=sic, device="cpu"), x[:, :4])
    # in turns, so that a change in the host's load meets both alike
    pairs = [(time_decode(dec_m, x, 1)[0], time_decode(dec_s, x, 1)[0])
             for _ in range(MIMO_REPS // 2)]
    t_m, t_s = (float(np.median(t)) for t in zip(*pairs))
    f = dec_s.front(x)
    cb0, _, ok0, _ = dec_s.turbo0(f.d0)
    d1 = dec_s.cancel(cb0, ok0, f)
    stages = {"front_ms": cuda_time_ms(lambda: dec_s.front(x), 3),
              "turbo0_ms": cuda_time_ms(lambda: dec_s.turbo0(f.d0), 3),
              "cancel_ms": cuda_time_ms(lambda: dec_s.cancel(cb0, ok0, f), 3),
              "reencode_ms": cuda_time_ms(
                  lambda: turbo_reencode_batch(cb0, g4.k), 5),
              "turbo1_ms": cuda_time_ms(lambda: dec_s.turbo1(d1), 3)}
    n_tb = 2 * MIMO_TM4_BATCH
    print(f"[mimo] TM4 corr B={MIMO_TM4_BATCH}: MMSE {mm['n_ok']}/{n_tb} in "
          f"{t_m * 1e3:.3f} ms, SIC {sc['n_ok']}/{n_tb} in {t_s * 1e3:.3f} ms "
          f"(medians, n={len(pairs)} each, in turns); SIC by CUDA events: "
          + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in stages.items())
          + f" ms; peak allocated MMSE {mm['peak_gb']:.2f}, SIC "
          f"{sc['peak_gb']:.2f} GB ({card})")
    return {"tm3": tm3, "tm4_mmse": {**mm, "decode_ms": t_m * 1e3,
                                     "mbit_per_s": mm["n_ok"] * g4.tbs
                                     / t_m / 1e6},
            "tm4_sic": {**sc, "decode_ms": t_s * 1e3,
                        "mbit_per_s": sc["n_ok"] * g4.tbs / t_s / 1e6,
                        **stages}}


def si_captures() -> tuple[list, list]:
    """Four 40 ms captures of 20 MHz cells (seed SEED + 7) under
    ``WORK/si``: one port with DCI 1A grants; two ports with DCI 1C grants
    and ``SI_TMSI`` paged; four ports; two ports at 20 Msps (the scanner
    resamples it).  CFO uniform in +-5 kHz, SNR in 10-20 dB, start offset
    in [0, 10 ms), a random start SFN."""
    rng = np.random.default_rng(SEED + 7)
    work = WORK / "si"
    work.mkdir(parents=True, exist_ok=True)
    nsf10 = 10 * SCAN_CFG.n_samps_subframe
    specs = ((1, "1a", (), None), (2, "1c", SI_TMSI, None),
             (4, "1a", (), None), (2, "1a", (), SDR_RATE))
    chans, caps = [], []
    for k, (n_ant, dci, tmsi, rate) in enumerate(specs):
        cell = cell_gen.Cell(n_rb_dl=100, n_cell_id=int(rng.integers(504)),
                             n_ant=n_ant, si_dci=dci, paging_tmsi=tmsi,
                             tac=0x3000 + k)
        cap = cell_gen.capture(
            cell, SI_S, sfn0=int(rng.integers(1024)),
            offset=int(rng.integers(0, nsf10)),
            cfo_hz=float(rng.uniform(-5e3, 5e3)),
            snr_db=float(rng.uniform(10.0, 20.0)), rate_hz=rate,
            seed=SEED + 20 + k, device="cuda")
        path = work / f"si{k}.fc32"
        write_iq(str(path), cap.iq)
        chans.append(scanner.Channel(str(4000 + k), str(path), rate_hz=rate))
        caps.append((cell, cap))
    return chans, caps


def run_si(dev, card: str) -> dict:
    """The SI path: four captures through ``scan_channels(prescan=True)``,
    twice (the first run warms caches, the second is reported), each
    reporting the SIB1, SIB2 and paging it was made with; the 1C /
    paging channel's report on the card equal to its report on the CPU in
    every integer field, the MIB, the SIBs and paging."""
    t0 = time.perf_counter()
    poly_mod.LAUNCHES = 0
    chans, caps = si_captures()
    gen_k6 = poly_mod.LAUNCHES
    print(f"[si-gen] {len(chans)} captures of {SI_S * 1e3:.0f} ms at 20 MHz:"
          f" {time.perf_counter() - t0:.2f} s; resample_poly launches "
          f"{gen_k6} (the 20 Msps capture, resampled on the card)")
    if gen_k6 != 1:
        raise AssertionError(f"the SI captures launched resample_poly "
                             f"{gen_k6} times, not once")
    runs = [scan_counted(tag, chans, caps, dev, card, all_si=True)
            for tag in ("first", "second")]
    run = runs[1]
    k6 = run["launches"]["resample_poly"]
    if k6 <= 0:
        raise AssertionError("the SI path's SDR capture never launched "
                             "resample_poly")
    card_rep = run["reports"][1]
    t0 = time.perf_counter()
    cpu_rep = scanner.scan_channels([chans[1]], SCAN_CFG, device="cpu")[0]
    cpu_s = time.perf_counter() - t0
    floats = ("cfo_hz", "rsrp_dbfs", "snr_db", "evm_pct")
    differ = [k for k in card_rep if k not in floats
              and card_rep[k] != cpu_rep.get(k)]
    gaps = {k: abs(card_rep[k] - cpu_rep[k]) for k in floats}
    print(f"[si-cpu-vs-card] channel {chans[1].label}: every integer field, "
          f"the MIB, SIB1, SIB2 and paging equal: {not differ}; |diff| "
          f"{gaps}; CPU scan {cpu_s:.2f} s ({card})")
    if differ or gaps["cfo_hz"] > 1.0 or gaps["rsrp_dbfs"] > 0.1 or \
            gaps["snr_db"] > 0.1:
        raise AssertionError(f"SI scan on the card vs the CPU: {differ}, "
                             f"{gaps}")
    n = len(chans)
    return {"wall_ms_per_channel": run["wall_s"] * 1e3 / n,
            "first_wall_ms_per_channel": runs[0]["wall_s"] * 1e3 / n,
            "stages": run["stages"], "reads": run["reads"],
            "launches": {**run["launches"],
                         "turbo_half_iteration": run["turbo_launches"],
                         "demap": run["demap_launches"]},
            "capture_launches": gen_k6}


def run_dl_wrap(dev, card: str) -> dict:
    """A rate match that wraps: 256 subframes of 100 PRB MCS 0 through the
    DL decoder (the demap kernel, the de-match as a sum of 4 cycle gathers,
    the turbo kernel), every transport block decoded to the bits sent."""
    geom = WRAP_CELL.geom
    t0 = time.perf_counter()
    iq, tb_ref = dl_subframes(WRAP_CELL, BATCH, WRAP_SNR_DB, seed=SEED)
    print(f"[dl-wrap-gen] {BATCH} subframes, MCS {WRAP_CELL.mcs}, TBS "
          f"{geom.tbs}, C={geom.info.c}, K={geom.k}, G={geom.g}, "
          f"{WRAP_SNR_DB} dB: {time.perf_counter() - t0:.2f} s")
    dec = make_batch_decoder(*WRAP_CELL.decoder_args(), device=dev)
    cycles = dec.dl_front.grid_inv.shape[0]
    if cycles != WRAP_CYCLES:
        raise AssertionError(f"dl-wrap: a plan of {cycles} cycles, "
                             f"{WRAP_CYCLES} expected")
    x = torch.from_numpy(iq).to(dev)
    out = decode_counted("dl-wrap", dec, x, tb_ref, BATCH)
    card_vs_cpu("dl-wrap", dec, make_batch_decoder(
        *WRAP_CELL.decoder_args(), device="cpu"), x[:4])
    t_med, t_p90 = time_decode(dec, x, WRAP_REPS)
    front_ms = cuda_time_ms(lambda: dec.front(x), 5)
    mbps = BATCH * geom.tbs / t_med / 1e6
    print(f"[dl-wrap] decode B={BATCH}, {cycles} cycles: median "
          f"{t_med * 1e3:.3f} ms/batch, p90 {t_p90 * 1e3:.3f} (n={WRAP_REPS})"
          f", {mbps:.2f} Mbit/s; front {front_ms:.3f} ms ({card})")
    return {**out, "cycles": cycles, "decode_ms": t_med * 1e3,
            "decode_p90_ms": t_p90 * 1e3, "mbit_per_s": mbps,
            "front_ms": front_ms}


def run_probe(dev, card: str) -> dict:
    """The probe's entry point, as its CLI drives it."""
    acs_mod.LAUNCHES = 0
    res = acs_probe.run(rounds=PROBE_ROUNDS[-1], reps=5, device=dev)
    launches = acs_mod.LAUNCHES
    if launches <= 0:
        raise AssertionError("the probe path never launched acs_probe")
    print(f"[probe] {res['elements']} elements x {res['rounds']} rounds: f32 "
          f"{res['f32']['ms']:.4f} ms = {res['f32']['tops']:.2f} T add/max "
          f"per s, bf16 {res['bf16']['ms']:.4f} ms = "
          f"{res['bf16']['tops']:.2f}; bf16/f32 {res['ratio']:.3f}; launches "
          f"{launches} ({card})")
    return {**res, "launches": launches}


def _reset_counts() -> None:
    demap_mod.LAUNCHES = turbo_mod.LAUNCHES = 0
    pss_mod.CORR_LAUNCHES = pss_mod.CORR_BF16_LAUNCHES = 0
    host.READS = 0


def _counts() -> dict:
    return {"demap": demap_mod.LAUNCHES,
            "turbo_half_iteration": turbo_mod.LAUNCHES,
            "pss_corr_mag_bf16": pss_mod.CORR_BF16_LAUNCHES,
            "host_reads": host.READS}


def ctrl_signal() -> dict:
    """The ``[ctrl]`` subframes: {subframe: (samples (n,) complex64, DCIs,
    HI bits (n_groups, 8))}, AWGN at ``CTRL_SNR_DB`` per RE (seed
    SEED + 11)."""
    rng = np.random.default_rng(SEED + 11)
    n_g = phich.phich_subframe_idx(CTRL_CFG, CTRL_CID, CTRL_NG).shape[0]
    out = {}
    for sf, levels in CTRL_LEVELS.items():
        ue = [(f, l) for f in ctrl_gen.UE_FORMATS for l in levels
              if not (l == 1 and f in ("2", "2a"))]
        dcis = ctrl_gen.ue_dci_plan(CTRL_CFG, CTRL_CID, CTRL_CFI, CTRL_NG, sf,
                                    ue, CTRL_TPC, rng)
        hi = rng.integers(0, 2, (n_g, 8))
        grid = ctrl_gen.ctrl_subframe(CTRL_CFG, CTRL_CID, CTRL_CFI, CTRL_NG,
                                      sf, dcis, hi)
        x = subframe_to_samples(torch.from_numpy(grid), CTRL_CFG).numpy()
        nv = 10 ** (-CTRL_SNR_DB / 10)
        x = x + np.sqrt(nv / 2) * (rng.standard_normal(x.shape)
                                   + 1j * rng.standard_normal(x.shape))
        out[sf] = (x.astype(np.complex64), dcis, hi)
    return out


def ctrl_decode(x: torch.Tensor, sf: int, dcis: list) -> dict:
    """One control subframe's samples on their device: OFDM, the port-0
    CRS estimate and noise, the MMSE-equalised grid; the PCFICH's CFI;
    the SISO PDCCH LLRs de-interleaved (``pdcch_llrs_to_logical``); each
    DCI's blind decode on its RNTI (C-RNTIs with the UE space, TPC-RNTIs
    the common space), timed; every PHICH group's 8 metrics in one read."""
    cfg, cid, ng = CTRL_CFG, CTRL_CID, CTRL_NG
    dev = x.device
    g = samples_to_subframe(x, cfg)
    h = chest.estimate_channel(g, cfg, cid, sf, port=0).reshape(-1)
    nv = chest.estimate_noise_var(g, cfg, cid, sf)
    x_eq, eff = chest.equalize_siso(g.reshape(-1), h, nv)
    t = lambda i: torch.as_tensor(np.asarray(i).reshape(-1).astype(np.int64),
                                  device=dev)
    pc = t(pcfich_flat_idx(cfg, cid))
    cfi = host.read(pcfich.pcfich_decode(
        demodulate_maxlog(x_eq[pc], "qpsk", eff[pc]), cid, sf)[0])
    pd = t(pdcch_flat_idx(cfg, cid, cfi, ng))
    logical = pdcch.pdcch_llrs_to_logical(
        demodulate_maxlog(x_eq[pd], "qpsk", eff[pd]), cfg, cid, cfi, ng, sf)
    n_cce = pdcch.n_cce(cfg, cid, cfi, ng)
    found, times = [], []
    for d in dcis:
        kw = {} if d.fmt in ctrl_gen.TPC_FORMATS else {"subframe": sf}
        t0 = time.perf_counter()
        found.append(getattr(pdcch, f"pdcch_blind_decode_{d.fmt}")(
            logical, cfg.n_rb_dl, d.rnti, n_cce, **kw))
        times.append(time.perf_counter() - t0)
    hi = phich.phich_decode_subframe(x_eq, cfg, cid, ng, sf)
    return {"cfi": cfi, "found": found, "hi": hi, "times": times}


def _plain(m):
    return dataclasses.asdict(m) if dataclasses.is_dataclass(m) else m


def run_ctrl(dev, card: str) -> dict:
    """The ``[ctrl]`` path on the card (counted), then on the CPU: every
    DCI at its (start, L) with its message, every HI bit right, the card's
    found lists and HI bits equal to the CPU's, its metrics within 1e-4 of
    the largest."""
    t0 = time.perf_counter()
    sig = ctrl_signal()
    print(f"[ctrl-gen] {len(sig)} subframes, {CTRL_CFG.n_rb_dl} PRB, cfi "
          f"{CTRL_CFI}, {sum(len(v[1]) for v in sig.values())} DCIs, "
          f"{sig[1][2].size} HI bits each: {time.perf_counter() - t0:.2f} s")
    ctrl_decode(torch.from_numpy(sig[1][0]).to(dev), 1, sig[1][1][:1])
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_out = {sf: ctrl_decode(torch.from_numpy(x).to(dev), sf, dcis)
                for sf, (x, dcis, _) in sig.items()}
    wall = time.perf_counter() - t0
    counts = _counts()
    times = [t for o in card_out.values() for t in o["times"]]
    n_dci = n_hi = 0
    for sf, (x, dcis, hi) in sig.items():
        got, cpu = card_out[sf], ctrl_decode(torch.from_numpy(x), sf, dcis)
        if got["cfi"] != CTRL_CFI or cpu["cfi"] != CTRL_CFI:
            raise AssertionError(f"ctrl: CFI {got['cfi']} / {cpu['cfi']}")
        for d, f_card, f_cpu in zip(dcis, got["found"], cpu["found"]):
            hits = {(s, l): _plain(m) for m, s, l in f_card}
            if hits.get((d.start, d.l_agg)) != _plain(d.msg):
                raise AssertionError(f"ctrl: DCI {d.fmt} on {d.rnti:#x} at "
                                     f"({d.start}, {d.l_agg}) not found: "
                                     f"{list(hits)}")
            if [(_plain(m), s, l) for m, s, l in f_card] != \
                    [(_plain(m), s, l) for m, s, l in f_cpu]:
                raise AssertionError(f"ctrl: card and CPU blind decodes of "
                                     f"{d.fmt} on {d.rnti:#x} differ")
            n_dci += 1
        bits = (got["hi"] < 0).astype(int)
        gap = float(np.abs(got["hi"] - cpu["hi"]).max())
        if not np.array_equal(bits, hi) or \
                not np.array_equal((cpu["hi"] < 0).astype(int), hi) or \
                gap > 1e-4 * float(np.abs(cpu["hi"]).max()):
            raise AssertionError(f"ctrl: HI bits wrong or card != CPU "
                                 f"(|diff| {gap})")
        n_hi += hi.size
    if counts["demap"] or counts["turbo_half_iteration"]:
        raise AssertionError(f"ctrl: kernels launched {counts}")
    per = {f"L{l}": sorted({d.fmt for v in sig.values() for d in v[1]
                            if d.l_agg == l}) for l in (1, 2, 4, 8)}
    med = float(np.median(times)) * 1e3
    print(f"[ctrl] {n_dci}/{n_dci} DCIs at their (start, L) with their "
          f"fields (formats by L: {per}), {n_hi}/{n_hi} HI bits right, CFI "
          f"{CTRL_CFI}; card = CPU (found lists, HI bits); blind decode "
          f"median {med:.3f} ms (n={len(times)}, max "
          f"{max(times) * 1e3:.3f}); two subframes {wall * 1e3:.1f} ms; host "
          f"reads {counts['host_reads']} ({card})")
    return {"dcis": n_dci, "hi_bits": n_hi, "blind_decode_ms": med,
            "wall_ms": wall * 1e3, "host_reads": counts["host_reads"],
            "launches": counts}


def run_ul_single(dev, card: str) -> dict:
    """``[ul-single]`` and ``[ul-uci]``: ``UL_SINGLE_N`` subframes of the
    UL cell at 25 dB, one decode call each, counted; then the first
    subframe on the CPU, whose bits, TB and code-block CRC flags (and, in
    ``[ul-uci]``, ACK and RI) must equal the card's."""
    cell = UlCell()
    args = cell.decoder_args()
    out = {}
    for name, uci in (("ul-single", None), ("ul-uci", UCI)):
        t0 = time.perf_counter()
        iq, tb = ul_subframes(cell, UL_SINGLE_N, SNR_DB, seed=SEED + 9,
                              uci=uci, ack=UCI_ACK, ri=UCI_RI)
        g = torch.from_numpy(iq[..., 0] + 1j * iq[..., 1])
        print(f"[{name}-gen] {UL_SINGLE_N} subframes, TBS {cell.alloc.mcs_tbs}"
              f", {cell.alloc.scheme}{', UCI ' + str(uci) if uci else ''}: "
              f"{time.perf_counter() - t0:.2f} s")
        if uci is None:
            decode = lambda x: (*pusch.pusch_decode(x, *args), None, None)
            want = (None, None)
        else:
            decode = lambda x: pusch.pusch_decode_uci(x, *args, uci)
            want = (UCI_ACK, UCI_RI)
        gd = g.to(dev)
        decode(gd[0])                                  # warm-up
        _reset_counts()
        rows, times = [], []
        for i in range(UL_SINGLE_N):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bits, ok, cb_oks, ack, ri = decode(gd[i])
            rows.append((bits.cpu().numpy(), bool(ok), cb_oks.cpu().numpy(),
                         ack, ri))
            times.append(time.perf_counter() - t0)
        counts = _counts()
        good = sum(ok and np.array_equal(b, tb[i]) and (a, r) == want
                   for i, (b, ok, _, a, r) in enumerate(rows))
        k12 = counts["turbo_half_iteration"] / UL_SINGLE_N
        cpu = decode(g[0])
        same = (np.array_equal(cpu[0].numpy(), rows[0][0])
                and bool(cpu[1]) == rows[0][1]
                and np.array_equal(cpu[2].numpy(), rows[0][2])
                and cpu[3:] == rows[0][3:])
        med = float(np.median(times)) * 1e3
        print(f"[{name}] {good}/{UL_SINGLE_N} with CRC, bits"
              f"{', ACK and RI' if uci else ''} right; median {med:.3f} ms a "
              f"subframe (n={UL_SINGLE_N}, host clock, read included); "
              f"turbo_half_iteration {k12:.1f} launches a subframe, demap "
              f"{counts['demap']}; card = CPU on subframe 0 (bits, TB and CB "
              f"CRC flags{', ACK, RI' if uci else ''}): {same} ({card})")
        if good != UL_SINGLE_N or k12 != 12 or counts["demap"] or not same:
            raise AssertionError(f"{name}: {good}/{UL_SINGLE_N} right, "
                                 f"{counts}, card = CPU {same}")
        out[name] = {"n_ok": good, "ms_per_subframe": med,
                     "turbo_per_subframe": k12, "launches": counts}
    return out


def run_ul_bench(card: str) -> dict:
    """``[ul-bench]``: the UL bench CLI at B=256 on the card, counted; its
    JSON line printed after the tag."""
    _reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = ul_throughput.main(["--batch", str(BATCH), "--reps", "10"])
    counts = _counts()
    print(f"[ul-bench] {buf.getvalue().strip()}")
    print(f"[ul-bench] launches {counts} ({card})")
    if res["crc_ok"] != BATCH or res["unit"] != "Mbit/s/GPU" or \
            counts["demap"] <= 0 or counts["turbo_half_iteration"] <= 0:
        raise AssertionError(f"ul-bench: {res}, {counts}")
    return {**res, "launches": counts}


def run_bler(dev, card: str) -> dict:
    """``[bler]``: the config #2 gate at both stored curves, then config
    #2's own sweep, on the card, counted together."""
    _reset_counts()
    out = {}
    for n_rb, mcs in BLER_CURVES:
        t0 = time.perf_counter()
        gate = snr_sweep.bler_gate(n_rb, mcs, device=dev)
        pts = "; ".join(f"{s:+.1f} dB BLER {bl:.3f} in [{lo:.3f}, {hi:.3f}] "
                        f"BER {be:.5f}" for s, lo, hi, bl, be
                        in gate["points"])
        print(f"[bler] gate {n_rb} PRB MCS {mcs} ({gate['scheme']}, 2 seeds x "
              f"24 blocks, production decoder): {pts}; "
              f"{'pass' if gate['ok'] else 'FAIL'}; "
              f"{time.perf_counter() - t0:.2f} s ({card})")
        if not gate["ok"]:
            raise AssertionError(f"bler gate {n_rb} PRB MCS {mcs}: {gate}")
        out[f"{n_rb}prb_mcs{mcs}"] = gate["points"]
    t0 = time.perf_counter()
    tbs, scheme, res = snr_sweep.sweep(**CONFIG2, device=dev)
    print(f"[bler] config #2 sweep, {CONFIG2}, TBS {tbs} {scheme}, "
          f"single-subframe decoder: " + "; ".join(
              f"{e:.2f},{ber:.5f},{bler:.3f}" for e, ber, bler in res)
          + f" (esn0_db,ber,bler); {time.perf_counter() - t0:.2f} s ({card})")
    if res[0][2] != 1.0 or not res[-1][2] < 1.0:
        raise AssertionError(f"config #2 sweep shows no waterfall: {res}")
    counts = _counts()
    if counts["demap"] or counts["turbo_half_iteration"] <= 0:
        raise AssertionError(f"bler: launches {counts}")
    return {"gates": out, "config2": res, "launches": counts}


def run_config3(dev, card: str) -> dict:
    """``[config3]``: the three gates at 50 PRB on the card, counted."""
    _reset_counts()
    t0 = time.perf_counter()
    nv = config3.noise_estimate(dev)
    mse = config3.chest_mse(dev)
    loop = config3.sfbc_loopback(dev)
    counts = _counts()
    print(f"[config3] 50 PRB EVA 10 dB: noise estimate / true "
          f"{nv['ratio']:.4f} (gate 0.5-2); MSE MMSE {mse['mmse_mse']:.3e} < "
          f"LS {mse['ls_mse']:.3e}: {mse['ok']}; 2-port SFBC loopback: cell "
          f"{loop['n_cell_id']}, n_ant {loop['n_ant']}, MIB {loop['mib']}, "
          f"SIB1 (TAC {loop['sib1_tac']:#x}) {loop['sib1']}, SIB2 "
          f"{loop['sib2']}, SI CRC failures {loop['sib_crc_fails']}; "
          f"launches {counts}; {time.perf_counter() - t0:.2f} s ({card})")
    if not (nv["ok"] and mse["ok"] and loop["ok"]) or counts["demap"] or \
            counts["turbo_half_iteration"] <= 0:
        raise AssertionError(f"config3: {nv}, {mse}, {loop}, {counts}")
    return {"noise_ratio": nv["ratio"], "ls_mse": mse["ls_mse"],
            "mmse_mse": mse["mmse_mse"], "loopback": loop,
            "launches": counts}


# -- slices G and J: loopback CLIs, the streaming scanner, IQ staging, trace


def _run_cli(args: list[str], timeout: float = 600) -> str:
    """``python -m`` one of the port's CLIs from the repository root, on
    the card (the CLIs' default); its standard output.  A failure raises
    with its output; a timeout kills it."""
    res = subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode:
        raise AssertionError(f"{' '.join(args[:1])} failed ({res.returncode})"
                             f":\n{res.stdout}\n{res.stderr}")
    return res.stdout


def _loopback_case(name: str, n_rb: int, frames: int, fmt: str) -> dict:
    """``file_gen`` then ``file_scan`` as subprocesses: the file, the
    generator's ms per subframe (its own clock) and the parsed report."""
    path = WORK / f"{name}.{fmt}"
    t0 = time.perf_counter()
    gen = _run_cli(["lteax_torch.apps.file_gen", "--out", str(path),
                    "--n-rb", str(n_rb), "--cell-id", str(LOOP_CELL),
                    "--frames", str(frames), "--fmt", fmt])
    t1 = time.perf_counter()
    out = _run_cli(["lteax_torch.apps.file_scan", str(path), "--n-rb",
                    str(n_rb), "--fmt", fmt])
    return {"name": name, "path": path, "n_rb": n_rb, "frames": frames,
            "fmt": fmt, "gen_ms_per_sf": float(gen.split("generated in ")[1]
                                               .split(" ms")[0]),
            "gen_wall_s": t1 - t0, "scan_wall_s": time.perf_counter() - t1,
            "report": json.loads(out.strip().splitlines()[-1])}


def _check_loopback_report(rep: dict, n_rb: int, tag: str) -> None:
    if (rep["n_cell_id"], rep["n_ant"], (rep["mib"] or {}).get("n_rb_dl"),
            rep["sib1"] is None, rep["sib2"] is None,
            rep["sib_crc_fails"]) != (LOOP_CELL, 1, n_rb, False, False, 0):
        raise AssertionError(f"[loopback] {tag}: {rep}")


def run_loopback(dev, card: str) -> dict:
    """``[loopback]``: config #1 and its 100-PRB and sc8 variants through
    the port's ``file_gen`` and ``file_scan`` CLIs as subprocesses on the
    card (the three in parallel), each report checked and equal to the
    CPU's scan of the same file and to a counted in-process scan on the
    card; then ``generate()`` at 100 PRB with extended CP and with extra
    SIBs on a three-message SI schedule, scanned on the card, counted."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LOOP_CASES)) as pool:
        cases = list(pool.map(lambda c: _loopback_case(*c), LOOP_CASES))
    cli_s = time.perf_counter() - t0
    _reset_counts()
    cpu_s = 0.0
    for c in cases:
        tag = f"{c['name']} ({c['n_rb']} PRB, {c['frames']} frames, " \
              f"{c['fmt']})"
        _check_loopback_report(c["report"], c["n_rb"], tag)
        x = read_iq(str(c["path"]), c["fmt"])
        cfg = PhyConfig(n_rb_dl=c["n_rb"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        card_rep = json.loads(file_scan.scan(x, cfg, device=dev).to_json())
        c["scan_ms"] = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        cpu_rep = json.loads(file_scan.scan(x, cfg, device="cpu").to_json())
        cpu_s += time.perf_counter() - t1
        if not c["report"] == card_rep == cpu_rep:
            raise AssertionError(f"[loopback] {tag}: CLI report "
                                 f"{c['report']}, in-process card "
                                 f"{card_rep}, CPU {cpu_rep}")
        print(f"[loopback] {tag}: CLIs on the card: cell {LOOP_CELL}, MIB, "
              f"SIB1 (TAC {c['report']['sib1']['tac']:#x}), SIB2, 0 SI CRC "
              f"failures; report equal to the CPU's scan (parsed); "
              f"file_gen {c['gen_ms_per_sf']:.3f} ms per subframe (its "
              f"clock, cold), in-process card scan {c['scan_ms']:.1f} ms "
              f"({len(x) / c['scan_ms'] / 1e3:.2f} Msps) ({card})")
    counts = _counts()
    sibs = (rrc.Sib3(q_hyst_db=6),
            rrc.Sib5(carriers=(rrc.InterFreqCarrier(dl_earfcn=2850),)),
            rrc.Sib9(hnb_name=b"win-cell"))
    gen_cases = (
        ("extended CP", file_gen.GenConfig(
            n_rb_dl=100, n_cell_id=77, n_frames=4, tac=0xECB,
            extended_cp=True)),
        # the scan locks to frame 1 at 100 PRB (the PSS peak sits 5
        # samples early: frame_start wraps), after SI message 2's window
        # in frame 2: 12 frames carry its next window, in frame 10
        ("extra SIBs, 3 SI messages", file_gen.GenConfig(
            n_rb_dl=100, n_cell_id=99, n_frames=12, tac=0xC0DE,
            extra_sibs=sibs,
            si_schedule=((8, (3,)), (8, (5,)), (8, (9,))))))
    gen_out = {}
    _reset_counts()
    for tag, gc in gen_cases:
        file_gen.generate(gc, device=dev)            # plans warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x = file_gen.generate(gc, device=dev)
        gen_ms = (time.perf_counter() - t1) * 1e3 / (10 * gc.n_frames)
        t1 = time.perf_counter()
        r = file_scan.scan(x, gc.phy, max_si_subframes=10 * gc.n_frames,
                           device=dev)
        scan_ms = (time.perf_counter() - t1) * 1e3
        sent = {f"sib{cell_gen._sib_type(s)}": s for s in gc.extra_sibs}
        if (r.n_cell_id, r.sib_crc_fails) != (gc.n_cell_id, 0) or \
                r.sib1 != gc.sib1() or r.sib2 != rrc.Sib2() or \
                r.sibs != sent:
            raise AssertionError(f"[loopback] generate() {tag}: "
                                 f"{r.to_json()}")
        gen_out[tag] = {"gen_ms_per_sf": gen_ms, "scan_ms": scan_ms,
                        "sfn": r.sfn, "sibs": sorted(r.sibs)}
        print(f"[loopback] generate() 100 PRB, {tag}, {gc.n_frames} frames: "
              f"{gen_ms:.3f} ms per subframe (warm, host grids + card OFDM); "
              f"scan {scan_ms:.1f} ms: cell {r.n_cell_id} from SFN {r.sfn}, "
              f"SIB1, SIB2{', ' if sent else ''}{', '.join(sorted(sent))}, "
              f"0 SI CRC failures ({card})")
    gen_counts = _counts()
    if counts["turbo_half_iteration"] <= 0 or \
            counts["pss_corr_mag_bf16"] != len(cases) or counts["demap"] or \
            gen_counts["turbo_half_iteration"] <= 0 or gen_counts["demap"]:
        raise AssertionError(f"[loopback] launches {counts}, {gen_counts}")
    print(f"[loopback] launches (in-process card scans of the 3 files) "
          f"{counts}, (the 2 generate() scans) {gen_counts}; CLIs "
          f"{cli_s:.1f} s in parallel, CPU scans {cpu_s:.1f} s ({card})")
    return {"cases": {c["name"]: {k: c[k] for k in
                                  ("n_rb", "frames", "fmt", "gen_ms_per_sf",
                                   "gen_wall_s", "scan_wall_s", "scan_ms")}
                      for c in cases},
            "generate": gen_out, "launches": {
                k: counts[k] + gen_counts[k] for k in counts}}


def _tcp_send(port: int, data: bytes, chunk: int = 1 << 20) -> threading.Thread:
    """A local sender thread streaming ``data`` to 127.0.0.1:``port``."""
    def send():
        with socket.create_connection(("127.0.0.1", port), timeout=30) as c:
            for i in range(0, len(data), chunk):
                c.sendall(data[i:i + chunk])
    t = threading.Thread(target=send, daemon=True)
    t.start()
    return t


def _ctrl_cmd(port: int, line: str) -> str:
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(line.encode() + b"\n")
        return s.makefile().readline().strip()


def run_stream(dev, card: str) -> dict:
    """``[stream]``: a 20 MHz fc32 file of ``STREAM_FRAMES`` frames through
    ``StreamScanService`` in windows of ``STREAM_WINDOW_SF`` subframes: a
    one-shot run with ``status`` read over the ctrl socket while it runs;
    2 windows, stop, resume to the end: the reports equal the one-shot
    run's.  The native reader against numpy; TCP ingest of the file; one
    window streamed over TCP equal to the file's; the recorder's sc8 ->
    fc32 equal to ``read_iq``'s."""
    gc = file_gen.GenConfig(n_rb_dl=100, n_cell_id=STREAM_CELL,
                            n_frames=STREAM_FRAMES)
    cfg = gc.phy
    t0 = time.perf_counter()
    x = file_gen.generate(gc, device=dev)
    path, path8 = WORK / "stream.fc32", WORK / "stream.sc8"
    write_iq(str(path), x)
    write_iq(str(path8), x, "sc8")
    n_win = STREAM_FRAMES * 10 // STREAM_WINDOW_SF
    print(f"[stream-gen] {STREAM_FRAMES} frames at 100 PRB: {len(x)} samples"
          f", {path.stat().st_size / 1e6:.1f} MB fc32: "
          f"{time.perf_counter() - t0:.2f} s")

    # the native reader against numpy, page cache warm, in turns
    rates = {}
    for fmt, p in (("fc32", path), ("sc8", path8)):
        read_iq(str(p), fmt)
        t = {"native": [], "numpy": []}
        for _ in range(3):
            for how in t:
                t1 = time.perf_counter()
                got = (native.read_iq_native(str(p), fmt) if how == "native"
                       else read_iq(str(p), fmt))
                t[how].append(time.perf_counter() - t1)
        mb = p.stat().st_size / 1e6
        rates[fmt] = {how: mb / float(np.median(v)) for how, v in t.items()}
        if not np.array_equal(got, native.read_iq_native(str(p), fmt)
                              .view(np.complex64)[:, 0]):
            raise AssertionError(f"[stream] native {fmt} read != numpy's")
    print(f"[stream] read to float pairs, MB/s of file (median of 3, in "
          f"turns): fc32 native {rates['fc32']['native']:.0f}, numpy "
          f"{rates['fc32']['numpy']:.0f}; sc8 native "
          f"{rates['sc8']['native']:.0f}, numpy {rates['sc8']['numpy']:.0f}")

    # one-shot run, timed
    _reset_counts()
    svc = StreamScanService(str(path), cfg, window_sf=STREAM_WINDOW_SF,
                            device=dev)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_shot = svc.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        svc.stop()
    counts = _counts()
    if sorted(one_shot) != list(range(n_win)) or counts["demap"] or \
            counts["turbo_half_iteration"] <= 0 or \
            counts["pss_corr_mag_bf16"] != n_win:
        raise AssertionError(f"[stream] windows {sorted(one_shot)}, "
                             f"launches {counts}")
    for w, rec in one_shot.items():
        if (rec["n_cell_id"], rec["sib_crc_fails"], rec["sib1"] is None,
                rec["sib2"] is None) != (STREAM_CELL, 0, False, False) or \
                rec["mib"]["sfn"] % 1024 not in (w * STREAM_WINDOW_SF // 10,
                                                 w * STREAM_WINDOW_SF // 10
                                                 + 1):
            raise AssertionError(f"[stream] window {w}: {rec}")
    ms_win = wall * 1e3 / n_win
    msps = len(x) / wall / 1e6
    print(f"[stream] one-shot: {n_win} windows of {STREAM_WINDOW_SF} "
          f"subframes, cell {STREAM_CELL}, MIB, SIB1, SIB2, 0 SI CRC "
          f"failures in each; {ms_win:.1f} ms per window (read + scan), "
          f"{msps:.1f} Msps of capture scanned; launches {counts} ({card})")

    # 2 windows with ctrl status reads while they run, stop, resume
    ck = WORK / "stream_ckpt.json"
    ck.unlink(missing_ok=True)
    svc = StreamScanService(str(path), cfg, window_sf=STREAM_WINDOW_SF,
                            ckpt_path=str(ck), device=dev)
    statuses, box = [], {}
    try:
        th = threading.Thread(target=lambda: box.update(
            r=svc.run(max_windows=2)))
        th.start()
        while th.is_alive():
            statuses.append(json.loads(_ctrl_cmd(svc.ctrl.port,
                                                 "status")[3:]))
            time.sleep(0.05)
        th.join()
        final = json.loads(_ctrl_cmd(svc.ctrl.port, "status")[3:])
    finally:
        svc.stop()
    first = box["r"]
    live = [st for st in statuses if st["running"]]
    svc = StreamScanService(str(path), cfg, window_sf=STREAM_WINDOW_SF,
                            ckpt_path=str(ck), device=dev)
    try:
        resumed = svc.run()
    finally:
        svc.stop()
    if sorted(first) != [0, 1] or resumed != one_shot or not live or \
            final["windows_done"] != 2 or \
            set(json.loads(ck.read_text())) != {f"w{w}" for w in
                                                range(n_win)}:
        raise AssertionError(f"[stream] resume: {sorted(first)}, "
                             f"{sorted(resumed)}, equal {resumed == one_shot}"
                             f", statuses {statuses[:3]}, final {final}")
    print(f"[stream] 2 windows with ctrl status read {len(statuses)} times "
          f"while running (windows_done seen "
          f"{sorted({st['windows_done'] for st in live})}), stop, resume: "
          f"{n_win} windows, reports equal the one-shot run's ({card})")

    # TCP ingest of the whole file, then one window live through the service
    data = path.read_bytes()
    with native.IqTcpSource(fmt="fc32") as src:
        t0 = time.perf_counter()
        sender = _tcp_send(src.port, data)
        got = 0
        while got < len(x):
            b = src.read(len(x) - got, timeout_ms=5000)
            if not len(b):
                break
            got += len(b)
        ingest_s = time.perf_counter() - t0
        sender.join(timeout=30)
        while got + src.dropped < len(x):     # drops counted, none lost
            b = src.read(len(x), timeout_ms=1000)
            if not len(b):
                break
            got += len(b)
        dropped = src.dropped
    if got + dropped != len(x):
        raise AssertionError(f"[stream] TCP ingest: {got} received + "
                             f"{dropped} dropped of {len(x)}")
    n = STREAM_WINDOW_SF * cfg.n_samps_subframe
    with native.IqTcpSource(fmt="fc32") as src:
        svc = StreamScanService(None, cfg, window_sf=STREAM_WINDOW_SF,
                                tcp_source=src, live_idle_s=5.0, device=dev)
        sender = _tcp_send(src.port, data[:8 * n])
        try:
            live_res = svc.run(max_windows=1)
            st = svc.status()
        finally:
            sender.join(timeout=30)
            svc.stop()
    if live_res.get(0) != one_shot[0] or st["overruns_dropped"]:
        raise AssertionError(f"[stream] live window: {live_res}, {st}")
    print(f"[stream] TCP ingest (fc32, one local sender, 4 Mi-sample ring): "
          f"{got} samples in {ingest_s * 1e3:.1f} ms = "
          f"{got / ingest_s / 1e6:.1f} Msps, dropped {dropped}; a live "
          f"window over TCP: dropped 0, report equal to the file window's "
          f"({card})")

    # the recorder: sc8 -> fc32
    rec_path = WORK / "stream_rec.fc32"
    t0 = time.perf_counter()
    n_rec = recorder.record(str(path8), str(rec_path), in_fmt="sc8",
                            out_fmt="fc32")
    rec_s = time.perf_counter() - t0
    if n_rec != len(x) or not np.array_equal(read_iq(str(rec_path)),
                                             read_iq(str(path8), "sc8")):
        raise AssertionError("[stream] recorder sc8 -> fc32 != read_iq")
    print(f"[stream] recorder sc8 -> fc32: {n_rec} samples in "
          f"{rec_s * 1e3:.1f} ms, equal to read_iq's ({card})")
    return {"windows": n_win, "window_sf": STREAM_WINDOW_SF,
            "ms_per_window": ms_win, "msps": msps, "read_mb_s": rates,
            "tcp_msps": got / ingest_s / 1e6, "tcp_dropped": dropped,
            "status_reads": len(statuses), "recorder_ms": rec_s * 1e3,
            "launches": counts}


def run_iq(dev, card: str) -> dict:
    """``[iq]``: the DL bench CLI at B=256 with f32, bf16 and sc8 IQ, in
    that order, each counted: 256/256 and the bits equal those sent; then
    ``prefetch_to_device`` feeding 8 host batches of 256 bf16 subframes to
    the decoder, against a plain copy before each decode."""
    out, launches = {}, {}
    for fmt in IQ_FORMATS:
        _reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = dl_throughput.main(["--batch", str(BATCH), "--reps",
                                      str(IQ_REPS), "--iq", fmt])
        launches[fmt] = _counts()
        print(f"[iq] {buf.getvalue().strip()}")
        if res["crc_ok"] != BATCH or not res["bits_equal"] or \
                res["unit"] != "Mbit/s/GPU" or launches[fmt]["demap"] <= 0 \
                or launches[fmt]["turbo_half_iteration"] <= 0:
            raise AssertionError(f"[iq] {fmt}: {res}, {launches[fmt]}")
        out[fmt] = {k: res[k] for k in ("value", "crc_ok", "n_iter")}
    cell = DlCell()
    dec = make_batch_decoder(*cell.decoder_args(), device=dev)
    iq, tb = dl_subframes(cell, BATCH, SNR_DB, seed=SEED)
    host_batch = stage_iq(iq, "bf16")
    dec(host_batch.to(dev))                     # warm
    times = {"prefetch": [], "copy": []}
    _reset_counts()
    for _ in range(2):                          # in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_ok = 0
        for x in prefetch_to_device([host_batch] * 8):
            bits, ok, _ = dec(x)
            n_ok += int(ok.sum())
        torch.cuda.synchronize()
        times["prefetch"].append((time.perf_counter() - t0) * 1e3 / 8)
        if n_ok != 8 * BATCH or not np.array_equal(bits.cpu().numpy(), tb):
            raise AssertionError(f"[iq] prefetch: {n_ok}/{8 * BATCH}")
        t0 = time.perf_counter()
        for _ in range(8):
            dec(host_batch.to(dev))
        torch.cuda.synchronize()
        times["copy"].append((time.perf_counter() - t0) * 1e3 / 8)
    pf_counts = _counts()
    pf_ms, copy_ms = (min(times[k]) for k in ("prefetch", "copy"))
    print(f"[iq] prefetch_to_device (bf16, depth 2, pinning thread, side "
          f"stream): 8 batches of {BATCH}, {n_ok}/{8 * BATCH}, bits equal "
          f"the sent; {pf_ms:.3f} ms per batch, against {copy_ms:.3f} with a "
          f"pageable copy before each decode (the better of 2 rounds each, "
          f"in turns); launches {pf_counts} ({card})")
    return {**out, "prefetch_ms": pf_ms, "copy_then_decode_ms": copy_ms,
            "launches": launches, "prefetch_launches": pf_counts}


def run_trace(card: str) -> dict:
    """``[trace]``: the DL bench CLI's ``--trace`` around one timed decode:
    the Chrome trace holds the ``decode_batch`` range and the turbo and
    demap kernels."""
    tdir = WORK / "trace"
    shutil.rmtree(tdir, ignore_errors=True)
    _reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = dl_throughput.main(["--batch", str(TRACE_BATCH), "--reps",
                                  "1", "--trace", str(tdir)])
    counts = _counts()
    with open(res["trace"]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    kernels = {k: sum(1 for e in events if e.get("cat") == "kernel"
                      and k in e.get("name", ""))
               for k in ("turbo_half_kernel", "demap_kernel")}
    ranges = names.count("decode_batch")
    print(f"[trace] {Path(res['trace']).name}: {len(events)} events, "
          f"'decode_batch' ranges {ranges}, kernels {kernels}, "
          f"{Path(res['trace']).stat().st_size / 1e6:.1f} MB; launches "
          f"{counts} ({card})")
    if res["crc_ok"] != TRACE_BATCH or not ranges or \
            not all(kernels.values()):
        raise AssertionError(f"[trace] {res}, ranges {ranges}, {kernels}")
    return {"events": len(events), "decode_batch_ranges": ranges,
            "kernels": kernels, "launches": counts}


# -- slice H: the UL control PHY and the attach simulators ------------------

def _same_prach(card_rows: list, cpu_rows: list, threshold: float) -> bool:
    """(index, delay) equal and metrics within 1e-4 relative; a row on one
    list only must lie within 1e-4 of the threshold."""
    g = {i: (d, m) for i, d, m in card_rows}
    c = {i: (d, m) for i, d, m in cpu_rows}
    for i in set(g) ^ set(c):
        if abs((g.get(i) or c.get(i))[1] / threshold - 1) >= 1e-4:
            return False
    return all(g[i][0] == c[i][0] and abs(g[i][1] - c[i][1])
               <= 1e-4 * abs(c[i][1]) for i in set(g) & set(c))


def _host_ms(fn, reps: int) -> float:
    """Median host-clock ms of one call of ``fn`` (it reads its result
    home, so the clock holds the device's work)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def run_prach(dev, card: str) -> dict:
    """PRACH format 0 at 30.72 Msps (24576-point window): every preamble
    of an unrestricted set (``preamble_set(22, 12)``, N_cs 119) and of a
    high-speed set (``preamble_set(22, 5, True)``, N_cs 38) as a burst
    with a random delay inside its zone, at 10 and at 0 dB per sample,
    detected on the card against its root's whole shift set; formats 1-3
    once each; noise alone at ``PRACH_NOISE_THRESHOLD``.  The sent
    preamble must come first at its delay (within one ZC sample), the
    card's list must equal the CPU's, noise must give nothing."""
    rng = np.random.default_rng(SEED + 41)
    spz = 24576 / prach.N_ZC                       # samples per ZC sample
    n_ok = n_same = n_calls = 0
    first = None
    for high_speed, zczc in ((False, PRACH_ZCZC), (True, PRACH_ZCZC_HS)):
        n_cs = (prach.NCS_RESTRICTED if high_speed
                else prach.NCS_UNRESTRICTED)[zczc]
        for u, cv in prach.preamble_set(PRACH_ROOT, zczc, high_speed):
            shifts = prach.cyclic_shifts(u, n_cs, high_speed)
            delay = int(rng.integers(0, int((n_cs - 2) * spz)))
            b = prach.generate_prach_cv(u, cv)
            b = np.concatenate([np.zeros(delay, np.complex64), b])[:len(b)]
            for snr_db in PRACH_SNRS:
                sig = np.sqrt(10 ** (-snr_db / 10) / 2)
                rx = (b + sig * (rng.standard_normal(len(b))
                                 + 1j * rng.standard_normal(len(b)))
                      )[prach.PRACH_FORMATS[0][0]:].astype(np.complex64)
                x = torch.as_tensor(rx, device=dev)
                got = prach.detect_prach_cv(x, u, shifts, n_cs)
                cpu = prach.detect_prach_cv(rx, u, shifts, n_cs,
                                            device="cpu")
                n_calls += 1
                best = max(got, key=lambda t: t[2]) if got else None
                n_ok += bool(best and best[0] == shifts.index(cv)
                             and abs(best[1] - delay) <= spz + 1)
                n_same += _same_prach(got, cpu, 8.0)
                first = first or (x, u, shifts, n_cs)
    for fmt in (1, 2, 3):
        u, cv = 129, 2 * 119
        rx = prach.generate_prach_cv(u, cv, fmt)[prach.PRACH_FORMATS[fmt][0]:]
        got = prach.detect_prach(torch.as_tensor(rx, device=dev), u, 119, fmt)
        n_calls += 1
        n_ok += bool(got) and max(got, key=lambda t: t[2])[:2] == (2, 0)
        n_same += _same_prach(got, prach.detect_prach(rx, u, 119, fmt,
                                                      device="cpu"), 8.0)
    noise_hits = 0
    for k in range(8):
        z = (rng.standard_normal(24576) + 1j * rng.standard_normal(24576)
             ).astype(np.complex64)
        noise_hits += len(prach.detect_prach(torch.as_tensor(z, device=dev),
                                             prach.physical_root(22 + k),
                                             119,
                                             threshold=PRACH_NOISE_THRESHOLD))
    x, u, shifts, n_cs = first
    detect = lambda: prach.detect_prach_cv(x, u, shifts, n_cs)
    ms = _host_ms(detect, 50)
    dev_ms, n_kernels = device_ms(detect, 20, count=True)
    n_bursts = n_calls - 3
    print(f"[ulctrl] PRACH format 0, 30.72 Msps: {n_bursts} bursts (64 "
          f"preambles of preamble_set({PRACH_ROOT}, {PRACH_ZCZC}) and of "
          f"the high-speed set ({PRACH_ROOT}, {PRACH_ZCZC_HS}) at "
          f"{PRACH_SNRS} dB) and formats 1-3: sent preamble first at its "
          f"delay {n_ok}/{n_calls}, card = CPU {n_same}/{n_calls}; noise "
          f"alone {noise_hits} detections in 8 windows at threshold "
          f"{PRACH_NOISE_THRESHOLD}; detect_prach "
          f"{ms:.3f} ms a call (host clock, median of 50, read included), "
          f"device time {_ms(dev_ms)} in {n_kernels:.0f} kernels ({card})")
    if n_ok != n_calls or n_same != n_calls or noise_hits:
        raise AssertionError(f"[ulctrl] PRACH: right {n_ok}, card = CPU "
                             f"{n_same} of {n_calls}, noise {noise_hits}")
    return {"bursts": n_bursts, "detect_ms": ms, "detect_device_ms": dev_ms,
            "detect_kernels": n_kernels}


def pucch_grid(rng) -> tuple[np.ndarray, list]:
    """A 100-PRB UL grid at ``PUCCH_SNR_DB`` per RE: formats 1 (SR), 1a and
    1b on orthogonal covers 0-2 of resource 0, 2 on resource 1, 2a on 2,
    2b on 3 (each slot-hopping between both band edges), every UE behind
    its own unit-gain phase; -> (grid, [(decode args, what was sent)])."""
    n_rb = PUCCH_N_RB
    grid = np.zeros((14, 12 * n_rb), np.complex64)
    cases = []

    def put(syms, m):
        return pucch.pucch_map_format1(
            grid, syms * np.exp(2j * np.pi * rng.random()), m, n_rb)

    for oc, bits in enumerate(((), (1,), (1, 0))):
        grid = put(pucch.pucch_format1_encode(bits, PUCCH_CID, 4, 2, oc), 0)
        cases.append(("1" + "ab"[len(bits) - 1] * bool(bits), 0,
                      (2, oc, len(bits)), bits))
    for m, ack in ((1, ()), (2, (1,)), (3, (0, 1))):
        cqi = tuple(int(b) for b in rng.integers(0, 2, 10 + len(ack)))
        syms = (pucch.pucch_format2ab_encode(np.array(cqi), ack, PUCCH_CID,
                                             4, 0x46, 1) if ack else
                pucch.pucch_format2_encode(np.array(cqi), PUCCH_CID, 4, 0x46,
                                           1))
        grid = put(syms, m)
        cases.append(("2" + ("", "a", "b")[len(ack)], m, (len(cqi), ack),
                      (cqi, ack)))
    sig = np.sqrt(10 ** (-PUCCH_SNR_DB / 10) / 2)
    grid = grid + sig * (rng.standard_normal(grid.shape)
                         + 1j * rng.standard_normal(grid.shape))
    return grid.astype(np.complex64), cases


def pucch_decode(grid, name: str, m: int, args: tuple):
    """One resource's decode -> its decisions (bits) and its metrics."""
    res = pucch.pucch_extract(grid, m, PUCCH_N_RB)
    if name.startswith("1"):
        alpha, oc, n_bits = args
        bits, metric = pucch.pucch_format1_decode(res, PUCCH_CID, 4, alpha,
                                                  oc, n_bits)
        return bits, (metric,)
    a, ack = args
    if not ack:
        cqi, metric = pucch.pucch_format2_decode(res, PUCCH_CID, 4, 0x46, a,
                                                 1)
        return (tuple(int(b) for b in cqi), ()), (metric,)
    cqi, ack_got, metric, ack_metric = pucch.pucch_format2ab_decode(
        res, PUCCH_CID, 4, 0x46, a, len(ack), 1)
    return (tuple(int(b) for b in cqi), ack_got), (metric, ack_metric)


def run_pucch_srs(dev, card: str) -> dict:
    """PUCCH formats 1/1a/1b/2/2a/2b and SRS (m_srs = ``SRS_M``) on a
    100-PRB grid, decoded on the card: the card's decisions equal the
    CPU's and what was sent, metrics within 1e-5 relative."""
    rng = np.random.default_rng(SEED + 42)
    grid, cases = pucch_grid(rng)
    g_card = torch.as_tensor(grid, device=dev)
    g_cpu = torch.from_numpy(grid)
    n_ok = 0
    for name, m, args, sent in cases:
        bits, metrics = pucch_decode(g_card, name, m, args)
        bits_c, metrics_c = pucch_decode(g_cpu, name, m, args)
        n_ok += bool(bits == bits_c == sent and all(
            abs(a - b) <= 1e-5 * abs(b) for a, b in zip(metrics, metrics_c)))
    present = [pucch.pucch_present(g_card, m, PUCCH_N_RB) for m in range(6)]
    pucch_ms = {name: _host_ms(lambda: pucch_decode(g_card, name, m, args),
                               20) for name, m, args, _ in cases}
    # SRS: three UEs on shifts 0, 3, 6 of one comb, each behind a delay
    ues = ((0, 1.0, 0.0), (3, 0.8, 3.0), (6, 1.1, 6.0))
    sgrid = np.zeros((14, 12 * PUCCH_N_RB), np.complex64)
    k = np.arange(12 * PUCCH_N_RB)
    for n_cs, amp, delay in ues:
        one = srs.srs_add(np.zeros_like(sgrid), PUCCH_N_RB, SRS_U, SRS_M,
                          n_cs, 1, 2, amp)
        sgrid += (one * np.exp(-2j * np.pi * k * delay / 2048)).astype(
            np.complex64)
    sgrid = (sgrid + 0.05 * (rng.standard_normal(sgrid.shape) + 1j
                             * rng.standard_normal(sgrid.shape))).astype(
                                 np.complex64)
    s_card = torch.as_tensor(sgrid, device=dev)
    p, peak = srs.srs_detect(s_card, PUCCH_N_RB, SRS_U, SRS_M, 1, 2)
    p_c, peak_c = srs.srs_detect(torch.from_numpy(sgrid), PUCCH_N_RB, SRS_U,
                                 SRS_M, 1, 2)
    strong = {int(i) for i in torch.topk(p, 3).indices.cpu()}
    srs_same = (torch.equal(peak.cpu(), peak_c) and strong ==
                {(8 - n) % 8 for n, _, _ in ues}
                and float((p.cpu() - p_c).abs().max()) <= 1e-5)
    h_err = max(float((srs.srs_estimate_channel(
        s_card, PUCCH_N_RB, SRS_U, SRS_M, n, 1, 2).cpu()
        - srs.srs_estimate_channel(torch.from_numpy(sgrid), PUCCH_N_RB,
                                   SRS_U, SRS_M, n, 1, 2)).abs().max())
        for n, _, _ in ues)
    srs_ms = _host_ms(lambda: [t.cpu() for t in srs.srs_detect(
        s_card, PUCCH_N_RB, SRS_U, SRS_M, 1, 2)], 20)
    print(f"[ulctrl] PUCCH at {PUCCH_N_RB} PRB, {PUCCH_SNR_DB} dB, resources "
          f"0-3 at both band edges: {n_ok}/{len(cases)} decodes right and = "
          f"CPU (formats {[c[0] for c in cases]}); present {present}; ms per "
          f"decode (host clock, read included) "
          f"{ {k: round(v, 3) for k, v in pucch_ms.items()} } ({card})")
    print(f"[ulctrl] SRS m_srs {SRS_M} at {PUCCH_N_RB} PRB, shifts 0/3/6: "
          f"windows {sorted(strong)}, peaks = CPU, powers within 1e-5: "
          f"{srs_same}; channel estimates max |card - CPU| {h_err:.2e}; "
          f"srs_detect {srs_ms:.3f} ms a call (host clock, read included) "
          f"({card})")
    if n_ok != len(cases) or present != [True] * 4 + [False] * 2 or \
            not srs_same or h_err > 1e-5:
        raise AssertionError(f"[ulctrl] PUCCH {n_ok}/{len(cases)}, present "
                             f"{present}, SRS {srs_same}, {h_err}")
    return {"pucch_ok": n_ok, "pucch_ms": pucch_ms, "srs_ms": srs_ms}


def run_ulctrl(dev, card: str) -> dict:
    """``[ulctrl]``: PRACH, PUCCH and SRS on the card, counted (none of
    them runs a hand-written kernel: FFTs, small matmuls and gathers)."""
    _reset_counts()
    out = {**run_prach(dev, card), **run_pucch_srs(dev, card)}
    counts = _counts()
    print(f"[ulctrl] launches {counts} ({card})")
    if counts["demap"] or counts["turbo_half_iteration"]:
        raise AssertionError(f"[ulctrl] launches {counts}")
    return {**out, "launches": counts}


def _recorded_attach(dev) -> tuple[dict, list]:
    """``attach_sim.run`` on ``dev`` with what its eNB decoded, in order:
    each PRACH detection's (index, delay) rows and each ``_dl_sch`` /
    ``_ul_sch`` transport block's bytes (None for a failed CRC)."""
    log = []
    saved = {name: getattr(attach_sim, name)
             for name in ("_prach_detect", "_dl_sch", "_ul_sch")}

    def recorded(name, fn):
        def call(*args, **kwargs):
            got = fn(*args, **kwargs)
            log.append((name, [r[:2] for r in got]
                        if name == "_prach_detect" else got))
            return got
        return call

    for name, fn in saved.items():
        setattr(attach_sim, name, recorded(name, fn))
    try:
        res = attach_sim.run(verbose=False, device=dev)
    finally:
        for name, fn in saved.items():
            setattr(attach_sim, name, fn)
    return res, log


def check_turbo_attach(dev) -> dict:
    """The half-iteration kernel vs plain at the attach paths' shapes
    (C = 1, K 280, 352, 528 and 1056, win 32, acq 16), timed at K 1056 as
    :func:`check_turbo_si`."""
    errs = []
    for k in ATTACH_K:
        errs += turbo_equal_plain(turbo_inputs(1, k + 3, 32, SEED + k, dev),
                                  32, 16)
    c, n, win, acq = 1, ATTACH_K[-1] + 3, 32, 16
    n_w = -(-n // win)
    u, v, a0, b0 = turbo_inputs(c, n, win, SEED + 7, dev)
    ms = cuda_time_ms(lambda: turbo_mod.half_iteration_raw(u, v, a0, b0,
                                                           win, acq), 100)
    plain_ms = cuda_time_ms(lambda: turbo_mod.half_iteration_plain(
        u, v, a0, b0, win, acq), 3)
    dev_ms = device_ms(lambda: turbo_mod.half_iteration_raw(u, v, a0, b0,
                                                            win, acq), 20,
                       "turbo_half")
    return {"shape": [c, n, win, acq], "max_abs_err": max(errs), "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            **bound(4 * (3 * c * n + 4 * c * n_w * 8),
                    c * n * 99 + c * n_w * acq * 60, F32_OPS_PER_S)}


def run_attach(dev, card: str) -> dict:
    """``[attach]``: ``attach_sim.run`` on the card, counted (10 turbo
    launches a transport block: 5 iterations, no early stop), then on the
    CPU, each PRACH detection and each transport block's decoded bytes
    equal to the card's;
    ``rrc_attach_sim.run`` on the card, counted; ms per ``_dl_sch`` /
    ``_ul_sch`` transport block at TBS 1032."""
    out = {}
    decoded = {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        _reset_counts()
        t0 = time.perf_counter()
        res, decoded[where] = _recorded_attach(d)
        out[f"{where}_wall_s"] = time.perf_counter() - t0
        counts = _counts()
        if where == "card":
            out["launches"] = counts
        if res != ATTACH_STAGES:
            raise AssertionError(f"[attach] {where}: {res}")
    n_tb = sum(name != "_prach_detect" for name, _ in decoded["card"])
    same = decoded["card"] == decoded["cpu"]
    _reset_counts()
    t0 = time.perf_counter()
    res = rrc_attach_sim.run(verbose=False, device=dev)
    out["rrc_wall_s"] = time.perf_counter() - t0
    out["rrc_launches"] = _counts()
    rng = np.random.default_rng(SEED + 43)
    msg = bytes(range(120))
    tb = np.unpackbits(np.frombuffer(msg.ljust(129, b"\0"), np.uint8)
                       ).astype(np.int32)
    alloc = pusch.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=1032, qm=2)
    geom = pdsch_mod.pdsch_geometry(1032, 1032, 2, 0)
    tb_ms = {name: _host_ms(lambda: fn(msg, 1032, 0x3D, 3, 214, 10 ** -1.2,
                                       rng, dev), 10)
             for name, fn in (("dl_sch", attach_sim._dl_sch),
                              ("ul_sch", attach_sim._ul_sch))}
    # the UE's side alone (numpy): what is left of a TB is the eNB's
    tb_ms["dl_encode"] = _host_ms(lambda: pdsch_mod.pdsch_encode(
        tb, geom, 0x3D, 3, 214, "qpsk"), 10)
    tb_ms["ul_encode"] = _host_ms(lambda: ul_gen.pusch_add_dmrs(
        ul_gen.pusch_encode_cbs(pdsch_mod.pdsch_prepare_cbs(tb, alloc.geom),
                                alloc, 0x3D, 3, 214), alloc, 214, 3), 10)
    k12 = out["launches"]["turbo_half_iteration"]
    k12_rrc = out["rrc_launches"]["turbo_half_iteration"]
    print(f"[attach] attach_sim on the card: 7/7 stages in "
          f"{out['card_wall_s']:.3f} s, on the CPU {out['cpu_wall_s']:.3f} s;"
          f" decoded card = CPU ({n_tb} TBs' bytes, PRACH (index, delay)) "
          f"{same}; "
          f"turbo_half_iteration {k12} launches ({k12 / 10:.1f} TBs), demap "
          f"{out['launches']['demap']}, host reads "
          f"{out['launches']['host_reads']} ({card})")
    print(f"[attach] rrc_attach_sim on the card: {res}, "
          f"{out['rrc_wall_s']:.3f} s; turbo_half_iteration {k12_rrc} "
          f"launches ({k12_rrc / 10:.1f} TBs), host reads "
          f"{out['rrc_launches']['host_reads']}; ms per TB at TBS 1032 (host"
          f" clock, median of 10): DL {tb_ms['dl_sch']:.3f} of which the UE's"
          f" numpy encode {tb_ms['dl_encode']:.3f}, UL {tb_ms['ul_sch']:.3f} "
          f"of which {tb_ms['ul_encode']:.3f} ({card})")
    if not same or n_tb != 8 or k12 != 80 or out["launches"]["demap"] or \
            res != RRC_STAGES or k12_rrc <= 0 or k12_rrc % 10 or \
            out["rrc_launches"]["demap"]:
        raise AssertionError(f"[attach] card = CPU {same}, {n_tb} TBs, "
                             f"{out}, {res}")
    return {**out, "tb_ms": tb_ms}


ENB_CFG = PhyConfig(n_rb_dl=ENB_N_RB)


def _enb_gc(n_rb: int = ENB_N_RB, cid: int = ENB_CID):
    return file_gen.GenConfig(n_rb_dl=n_rb, n_cell_id=cid)


def _tti_log() -> dict:
    return {"times": [], "reads": [], "turbo": [], "demap": []}


@contextlib.contextmanager
def tti_timed(log: dict, dev):
    """One TTI of a sim on ``dev``: its host seconds (the device
    synchronised at its end), host reads and K1/K2 and K3 launches are
    added to ``log`` (``_tti_log()``)."""
    r0, k0, d0 = host.READS, turbo_mod.LAUNCHES, demap_mod.LAUNCHES
    t0 = time.perf_counter()
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log["times"].append(time.perf_counter() - t0)
    log["reads"].append(host.READS - r0)
    log["turbo"].append(turbo_mod.LAUNCHES - k0)
    log["demap"].append(demap_mod.LAUNCHES - d0)


def enb_user_plane(dev) -> dict:
    """The traffic of the reference's ``test_two_ue_user_plane`` at 100
    PRB on ``dev``: two UEs over two frames; every grid, each receive's
    STATUS PDU, HARQ bit and SDU count, what each UE decoded, and each
    TTI's times, reads and launches and the stages' host seconds."""
    gc = _enb_gc()
    enb = enb_sim.EnbSim(gc, device=dev)
    ues = {}
    for rnti, k in zip((0x100, 0x200), ENB_K):
        enb.add_ue(rnti, k)
        ues[rnti] = enb_sim.UeSim(gc, rnti, k, device=dev)
    enb.send_rrc(0x100, b"rrc-reconfig-ue1")
    enb.send_data(0x100, b"ip-ue1-a")
    enb.send_data(0x100, b"ip-ue1-b")
    enb.send_data(0x200, b"ip-ue2")
    grids, rx, log = [], [], _tti_log()
    enb_sim.STAGE_SECONDS.clear()
    for sfn in range(2):
        for sf in range(10):
            with tti_timed(log, dev):
                grid = enb.tti_grid(sfn, sf)
                grids.append(grid)
                for rnti, ue in ues.items():
                    status = ue.handle_grid(grid, sf)
                    rx.append((sfn, sf, rnti, status, ue.pending_ack,
                               len(ue.data_sdus)))
                    if status is not None:
                        enb.handle_status(rnti, status)
    return {"grids": grids, "rx": rx,
            "sdus": {r: (ue.rrc_sdus, ue.data_sdus) for r, ue in ues.items()},
            "all_acked": enb.ues[0x100].srb_tx.all_acked, "tti": log,
            "stages": dict(enb_sim.STAGE_SECONDS)}


def enb_lost_subframe(dev) -> dict:
    """The traffic of the reference's ``test_srb_survives_lost_subframe``
    at 100 PRB on ``dev``: one UE, one SRB SDU whose first transmission's
    grid (0, 1) never reaches the UE, then RLC AM's poll retransmit and
    frame 0 again.  -> whether it arrived only after the retransmit, and
    each TTI's times, reads and launches and the stages' host seconds."""
    gc = _enb_gc()
    enb = enb_sim.EnbSim(gc, device=dev)
    enb.add_ue(0x100, ENB_K[0])
    ue = enb_sim.UeSim(gc, 0x100, ENB_K[0], device=dev)
    enb.send_rrc(0x100, b"must-arrive")
    log, before = _tti_log(), None
    enb_sim.STAGE_SECONDS.clear()
    for run in range(2):
        if run:
            before = list(ue.rrc_sdus)
            enb.ues[0x100].srb_tx.poll_retransmit()
        for sf in range(10):
            with tti_timed(log, dev):
                grid = enb.tti_grid(0, sf)
                if (run, sf) != (0, 1):
                    status = ue.handle_grid(grid, sf)
                    if status is not None:
                        enb.handle_status(0x100, status)
    return {"tti": log, "stages": dict(enb_sim.STAGE_SECONDS),
            "right": before == [] and ue.rrc_sdus == [b"must-arrive"]}


def enb_uplink(dev) -> list:
    """The UL control loop of ``tests/test_torch_enb_sim.py`` at 100 PRB on
    ``dev``: SR, the DCI 0 grant decoded (with the CRS CQI), PUSCH with a
    NACK on format 1, the HI read on the next DL grid, ACK + CQI on format
    2a, CQI on format 2, ACK on format 1, NACK + CQI on format 2a; after
    each step the eNB's decisions (SR set, HARQ copies, queue, UL SDUs,
    pending HI bits, CQI-capped MCS) and the UE's PHICH read."""
    gc = _enb_gc()
    enb = enb_sim.EnbSim(gc, device=dev)
    enb.add_ue(0x100, ENB_K[0], cqi_mcs=9)
    ue = enb_sim.UeSim(gc, 0x100, ENB_K[0], standing_grant=False,
                       cqi_period=1, device=dev)
    steps = []

    def state():
        return (sorted(enb._sr_pending), dict(enb._last_dl),
                list(enb.sched.ues[0x100].queue),
                list(enb.ues[0x100].ul_sdus), dict(enb._pending_hi),
                enb.sched.ues[0x100].cqi_mcs)

    def ul(sf, **set_ue):
        for k, v in set_ue.items():
            setattr(ue, k, v)
        g = ue.ul_tti_grid(sf)
        if g is not None:
            enb.handle_pusch(0x100, g, sf)
        steps.append(("ul", sf, state()))

    def dl(sfn, sf, *sdus, receive=False):
        for s in sdus:
            enb.send_data(0x100, s)
        g = enb.tti_grid(sfn, sf)
        got = ((ue.handle_grid(g, sf), ue.pending_ack, ue.granted,
                ue.meas_cqi, list(ue.data_sdus)) if receive else None)
        steps.append(("dl", sf, state(), ue.read_phich(g, sf), got))

    ue.send_ul(b"ul-needs-grant")
    ul(1)
    dl(0, 2, receive=True)
    dl(0, 3, b"harq-payload")
    ul(4, pending_ack=0)
    dl(0, 6)
    ul(7, pending_ack=1, meas_cqi=9, _cqi_due=True)
    ul(8, meas_cqi=12, _cqi_due=True)
    dl(1, 1, b"more")
    ul(2, pending_ack=1)
    dl(1, 3, b"nack-2a")
    ul(4, pending_ack=0, meas_cqi=7, _cqi_due=True)
    return steps


def _check_enb_uplink(steps: list) -> None:
    """The decisions the UL script must reach (as in the CPU test)."""
    s = [st[2] for st in steps]
    ok = (s[0][0] == [0x100] and s[1][0] == [] and steps[1][4][2] is True
          and steps[1][4][3] == 15 and s[3][2]
          and s[3][3] == [b"ul-needs-grant"] and s[3][4] == {0: 1}
          and steps[4][3] is True and s[5][1] == {} and s[5][5] == 15
          and s[6][5] == 22 and s[7][1] and s[8][1] == {} and s[9][1]
          and s[10][1] == {} and s[10][2] and s[10][5] == 11)
    if not ok:
        raise AssertionError(f"[enb] uplink decisions: {steps}")


def enb_handover(dev, n_rb: int) -> dict:
    """``tests/test_handover_sim.py`` on ``dev`` at ``n_rb`` PRB: attach on
    the source cell over the TTI loop, A3 measurement configuration, the
    report, the handover command, the dedicated preamble detected on the
    target cell, completion and user plane there.  -> its checks, and
    each TTI's times, reads and launches and the stages' host seconds."""
    imsi = tuple(int(d) for d in ENB_IMSI)
    k, opc = bytes.fromhex(ENB_K_HEX), bytes.fromhex(ENB_OPC_HEX)
    hss = Hss()
    hss.add_user(ENB_IMSI, ENB_K_HEX, ENB_OPC_HEX)
    users = UserManager()
    pci_s, pci_t, earfcn_t = ENB_CID, 201, 6300
    gc_s, gc_t = _enb_gc(n_rb, pci_s), _enb_gc(n_rb, pci_t)
    src = enb_sim.EnbSim(gc_s, rrc=EnbRrc(hss, users, pci=pci_s, seed=5),
                         device=dev)
    tgt = enb_sim.EnbSim(gc_t, rrc=EnbRrc(hss, users, pci=pci_t,
                                          earfcn=earfcn_t, seed=6),
                         device=dev)
    src.rrc.neighbors[pci_t] = earfcn_t
    src.rrc.neighbor_enb[pci_t] = tgt.rrc
    log = _tti_log()
    enb_sim.STAGE_SECONDS.clear()

    def loop(enb, ue, rnti, sfns, stop=None):
        for sfn in sfns:
            for sf in range(10):
                with tti_timed(log, dev):
                    g_ul = ue.ul_tti_grid(sf)
                    if g_ul is not None:
                        enb.handle_pusch(rnti, g_ul, sf)
                    status = ue.handle_grid(enb.tti_grid(sfn, sf), sf)
                    if status is not None:
                        enb.handle_status(rnti, status)
                if stop is not None and stop():
                    return True
        return stop() if stop is not None else True

    checks = {}
    rnti = src.handle_prach(rapid=7)
    ue = enb_sim.UeSim(gc_s, rnti, rrc_ue=UeRrc(imsi, k, opc), device=dev)
    ue.start_attach()
    checks["attach"] = loop(src, ue, rnti, range(5), lambda: (
        ue.rrc_ue.state == "connected" and src.rrc.proc(rnti) is not None
        and src.rrc.proc(rnti).state == "attach-done"))
    k_enb_before = ue.rrc_ue.k_enb
    src._rrc_out(rnti, src.rrc.configure_measurements(rnti))
    checks["meas_config"] = loop(src, ue, rnti, range(5, 8),
                                 lambda: ue.rrc_ue.meas_config is not None)
    ue._rrc_reply(ue.rrc_ue.measurement_report(
        1, serv_rsrp=50, serv_rsrq=20,
        neigh=(MeasResultEutra(pci_t, rsrp=62),)))
    checks["ho_command"] = loop(src, ue, rnti, range(8, 12),
                                lambda: ue.ho_pending is not None)
    new_rnti = ue.rrc_ue.c_rnti
    k_star = security.generate_k_enb_star(k_enb_before, pci_t, earfcn_t)
    checks["k_enb_star"] = (ue.rrc_ue.k_enb == k_star != k_enb_before
                            and tgt.rrc.proc(new_rnti).k_enb == k_star)
    rng = np.random.default_rng(SEED + 3)
    preamble = ue.rrc_ue.ho_rach[0]
    burst = prach.generate_prach(129, preamble, 119)
    rx = burst + (rng.standard_normal(len(burst)) + 1j * rng.standard_normal(
        len(burst))) * np.sqrt(10 ** -1.2 / 2)
    dets = prach.detect_prach(rx[prach.PRACH_FORMATS[0][0]:].astype(
        np.complex64), 129, 119, device=dev)
    checks["ho_rach"] = bool(dets) and max(dets, key=lambda t: t[2])[0] \
        == preamble
    tgt.admit_handover_ue(new_rnti)
    ue2 = ue.handover_retune(gc_t)
    checks["ho_complete"] = loop(
        tgt, ue2, new_rnti, range(4),
        lambda: "handover-complete" in tgt.rrc.events) and \
        tgt.rrc.proc(new_rnti).state == "attach-done"
    tgt.send_data(new_rnti, b"dl-after-ho")
    ue2.send_ul(b"ul-after-ho")
    loop(tgt, ue2, new_rnti, range(4, 7))
    checks["user_plane"] = (ue2.data_sdus == [b"dl-after-ho"] and
                            tgt.ues[new_rnti].ul_sdus == [b"ul-after-ho"])
    return {"checks": checks, "ttis": len(log["times"]), "tti": log,
            "stages": dict(enb_sim.STAGE_SECONDS)}


def enb_service_run(dev, iq_path: str | None) -> dict:
    """``EnbService`` at bandwidth 100 on ``dev`` through its ctrl socket:
    add_user, start, add_ue, step until connected, ping, detach_ue; every
    reply, the status strings and the UE's received SDUs.  With
    ``iq_path`` the DL waveform goes to that file."""
    svc = enb_service.EnbService(port=0, device=dev)
    replies = []
    try:
        p = svc.port

        def cmd(line: str) -> str:
            with socket.create_connection(("127.0.0.1", p),
                                          timeout=300) as c:
                c.sendall(line.encode() + b"\n")
                replies.append(c.makefile().readline().strip())
            return replies[-1]

        cmd(f"add_user {ENB_IMSI} {ENB_K_HEX} {ENB_OPC_HEX}")
        cmd(f"write bandwidth {ENB_N_RB}")
        cmd(f"write n_id_cell {ENB_SVC_CID}")
        if iq_path:
            cmd(f"write iq_out {iq_path}")
        cmd("start")
        cmd(f"add_ue {ENB_IMSI}")
        for _ in range(8):
            cmd("step 10")
            if "state=connected" in cmd("status"):
                break
        cmd(f"ping {ENB_IMSI}")
        cmd("step 10")
        cmd("status")
        cmd(f"detach_ue {ENB_IMSI}")
        cmd("step 20")
        cmd("status")
        su = next(iter(svc.ues.values()))
        sdus = list(su.ue.data_sdus)
        ttis = svc._tti
    finally:
        svc.close()
    return {"replies": replies, "sdus": sdus, "ttis": ttis}


@contextlib.contextmanager
def turbo_shapes_seen(log: dict):
    """Record the inputs of the first launch of the turbo kernel at each
    (C, n, win, acq) while the block runs (the launches still count)."""
    launch = turbo_mod.half_iteration_kernel

    def recorded(u, v, a_init, b_init, win, acq, wpb, *form):
        key = (u.shape[0], u.shape[1], win, acq)
        if key not in log:
            log[key] = tuple(x.clone() for x in (u, v, a_init, b_init))
        return launch(u, v, a_init, b_init, win, acq, wpb, *form)

    turbo_mod.half_iteration_kernel = recorded
    try:
        yield log
    finally:
        turbo_mod.half_iteration_kernel = launch


def check_turbo_enb(seen: dict, card: str) -> dict:
    """The half-iteration kernel vs plain on the inputs ``[enb]`` gave it,
    one launch at each of its shapes, bit for bit; timed at the longest
    (CUDA events back to back, profiler device time), with its bound."""
    errs = []
    for (c, n, win, acq), args in sorted(seen.items()):
        errs += turbo_equal_plain(args, win, acq)
    (c, n, win, acq), args = max(seen.items(), key=lambda kv: kv[0][1])
    n_w = -(-n // win)
    run = lambda: turbo_mod.half_iteration_raw(*args, win, acq)
    ms = cuda_time_ms(run, 100)
    dev_ms = device_ms(run, 20, "turbo_half")
    plain_ms = cuda_time_ms(lambda: turbo_mod.half_iteration_plain(
        *args, win, acq), 3)
    b = bound(4 * (3 * c * n + 4 * c * n_w * 8),
              c * n * 99 + c * n_w * acq * 60, F32_OPS_PER_S)
    shapes = sorted(seen)
    print(f"[kernel] turbo_half_iteration at the [enb] shapes (C, n, win, "
          f"acq) {shapes}: bit-exact vs plain on the inputs the path gave "
          f"it; kernel at {(c, n, win, acq)} {ms:.4f} ms a call back to "
          f"back, device time {_ms(dev_ms)} (profiler), plain "
          f"{plain_ms:.4f} ms, bound {b['bound_ms']:.6f} ms by "
          f"{b['bound_by']} ({b['bytes'] / 1e3:.1f} kB, {b['ops'] / 1e6:.3f}"
          f" M operations) ({card})")
    return {"shapes": shapes, "shape": [c, n, win, acq],
            "max_abs_err": max(errs), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, **b}


def _pct(x: list, q: float) -> float:
    return float(np.percentile(x, q)) * 1e3


def _print_tti(label: str, r: dict, card: str) -> None:
    """A timed sim run's line: ms a TTI, by stage, host reads, launches."""
    log, n = r["tti"], len(r["tti"]["times"])
    print(f"[enb] {label}, {n} TTIs at {ENB_N_RB} PRB: ms a TTI median "
          f"{_pct(log['times'], 50):.3f}, p90 {_pct(log['times'], 90):.3f}, "
          f"max {max(log['times']) * 1e3:.3f}; stage ms a TTI "
          + ", ".join(f"{k} {v * 1e3 / n:.3f}" for k, v in
                      sorted(r["stages"].items()))
          + f"; host reads a TTI {np.mean(log['reads']):.2f} (max "
          f"{max(log['reads'])}); turbo_half_iteration {sum(log['turbo'])} "
          f"({np.mean(log['turbo']):.2f} a TTI, max {max(log['turbo'])}), "
          f"demap {sum(log['demap'])} "
          f"({card})")


def run_enb(dev, card: str) -> dict:
    """``[enb]``: the eNB simulator and service at 100 PRB (20 MHz) on the
    card, each path counted (K1/K2 on every PDSCH / PUSCH decode, K3
    never), then on the CPU with the same inputs: what each side decoded
    must be equal (SDUs, STATUS PDUs, HARQ bits, SR, CQI, HI, the service's
    status strings).  The reference tests' traffic timed a TTI for 1 and 2
    UEs, by stage, with host reads, launches and the device's busy share;
    the service's IQ scanned back to its cell; the handover, timed a
    TTI."""
    t_phase = time.perf_counter()
    seen = {}
    with turbo_shapes_seen(seen):
        out = _run_enb(dev, card, t_phase)
    return {**out, "turbo": check_turbo_enb(seen, card)}


def _run_enb(dev, card: str, t_phase: float) -> dict:
    _reset_counts()
    up = enb_user_plane(dev)
    ul_steps = enb_uplink(dev)
    counts_sim = _counts()
    up_cpu = enb_user_plane(torch.device("cpu"))
    ul_cpu = enb_uplink(torch.device("cpu"))
    grid_gap = max(float(np.max(np.abs(a - b)))
                   for a, b in zip(up["grids"], up_cpu["grids"]))
    up_same = (up["rx"] == up_cpu["rx"] and up["sdus"] == up_cpu["sdus"]
               and up["all_acked"] == up_cpu["all_acked"])
    up_right = (up["sdus"][0x100] == ([b"rrc-reconfig-ue1"],
                                      [b"ip-ue1-a", b"ip-ue1-b"])
                and up["sdus"][0x200] == ([], [b"ip-ue2"])
                and up["all_acked"])
    n_status = sum(r[3] is not None for r in up["rx"])
    t_split = [time.perf_counter() - t_phase]
    _check_enb_uplink(ul_steps)
    ul_same = ul_steps == ul_cpu
    print(f"[enb] user plane (two UEs, two frames, 100 PRB): SDUs right "
          f"{up_right}; card = CPU (each receive's STATUS PDU, HARQ bit and "
          f"SDU count, {n_status} STATUS PDUs; the UEs' SDUs) {up_same}; "
          f"grids within {grid_gap:.2e} of the CPU's; uplink (SR, DCI 0, "
          f"PUSCH, NACK / ACK on formats 1 and 2a, CQI on 2 and 2a, HI) "
          f"card = CPU {ul_same}; launches {counts_sim} ({card})")
    if not (up_right and up_same and ul_same) or grid_gap > ENB_GRID_TOL \
            or counts_sim["turbo_half_iteration"] <= 0 or counts_sim["demap"]:
        raise AssertionError(f"[enb] user plane / uplink: {up_right}, "
                             f"{up_same}, {ul_same}, {grid_gap}, "
                             f"{counts_sim}")
    # the reference tests' traffic again, warm, timed a TTI: the 1-UE
    # lost-subframe recovery and the 2-UE user plane (its decodes equal to
    # the compared run's)
    _reset_counts()
    lost = enb_lost_subframe(dev)
    up2 = enb_user_plane(dev)
    counts_timed = _counts()
    if not lost["right"] or up2["rx"] != up["rx"] or \
            up2["sdus"] != up["sdus"] or counts_timed["demap"]:
        raise AssertionError(f"[enb] timed runs: {lost['right']}, "
                             f"{up2['rx']}, {counts_timed}")
    t_split.append(time.perf_counter() - t_phase - sum(t_split))
    _print_tti("1 UE, the reference's lost-subframe recovery (one SRB SDU, "
               "its grid lost, poll retransmit, frame 0 twice)", lost, card)
    _print_tti("2 UEs, the reference's two-UE user plane (one SRB and three "
               "DRB SDUs, two frames)", up2, card)
    # the device's busy share over the same 20 TTIs: its kernels' time
    # (profiled run) over their wall (the timed run, unprofiled)
    dev_ms, n_kernels = device_ms(lambda: enb_user_plane(dev), 1,
                                  count=True)
    if dev_ms is None:
        raise AssertionError("[enb] the profiler saw no kernel")
    wall_ms = sum(up2["tti"]["times"]) * 1e3
    busy = dev_ms / wall_ms
    print(f"[enb] device busy share over the 2-UE user plane's 20 TTIs: "
          f"{busy:.4f} ({dev_ms:.3f} ms of kernels and copies in "
          f"{n_kernels:.0f} launches (profiled run, the sims' set-up "
          f"included), {wall_ms:.3f} ms of wall (the timed run)) ({card})")
    t_split.append(time.perf_counter() - t_phase - sum(t_split))
    # the service, on the card with its IQ written, then on the CPU
    iq_path = WORK / "enb_service.fc32"
    WORK.mkdir(parents=True, exist_ok=True)
    _reset_counts()
    t0 = time.perf_counter()
    svc = enb_service_run(dev, str(iq_path))
    svc_s = time.perf_counter() - t0
    counts_svc = _counts()
    iq_cpu_path = WORK / "enb_service_cpu.fc32"
    svc_cpu = enb_service_run(torch.device("cpu"), str(iq_cpu_path))
    same = lambda r: [x for x in r if not x.startswith("ok iq_out")]
    svc_same = same(svc["replies"]) == same(svc_cpu["replies"]) and \
        svc["sdus"] == svc_cpu["sdus"]
    st = [r for r in svc["replies"] if r.startswith("ok tti=")
          and "imsi=" in r]
    svc_right = (any("state=connected" in r and "ip=10.0.0.2" in r
                     for r in st) and "rx=1" in st[-2]
                 and "state=idle" in st[-1]
                 and svc["sdus"] == [b"ping-" + ENB_IMSI.encode()])
    # the subframes without user data (the broadcast ones) must agree; the
    # others carry the AKA's random challenge, drawn anew in each run
    x = read_iq(str(iq_path))
    nsf = ENB_CFG.n_samps_subframe
    iq_gap = max(float(np.max(np.abs(d[0] - d[1]))) for d in (
        (a[sf * nsf:(sf + 1) * nsf], b[sf * nsf:(sf + 1) * nsf])
        for a, b in [(x, read_iq(str(iq_cpu_path)))] for sf in (0, 5, 9)))
    t0 = time.perf_counter()
    rep = file_scan.scan(torch.from_numpy(x).to(dev), ENB_CFG)
    scan_s = time.perf_counter() - t0
    scan_right = (rep.n_cell_id == ENB_SVC_CID and rep.mib is not None
                  and rep.mib.n_rb_dl == ENB_N_RB and rep.sib1 is not None
                  and rep.sib1.tac == 0x1234)
    print(f"[enb-service] bandwidth {ENB_N_RB}: attach, ping, detach over "
          f"the ctrl socket in {svc['ttis']} TTIs, {svc_s:.3f} s "
          f"({svc_s * 1e3 / svc['ttis']:.3f} ms a TTI, IQ out included); "
          f"status strings right {svc_right}; card = CPU (every reply, the "
          f"UE's SDUs) {svc_same}; launches {counts_svc}; its IQ of "
          f"subframes 0, 5, 9 within {iq_gap:.2e} of the CPU run's (limit "
          f"{ENB_IQ_TOL}); its IQ "
          f"({len(x)} samples) scanned on the card in {scan_s:.3f} s: cell "
          f"{rep.n_cell_id}, MIB n_rb_dl "
          f"{rep.mib.n_rb_dl if rep.mib else None}, SIB1 TAC "
          f"{hex(rep.sib1.tac) if rep.sib1 else None} ({card})")
    print(f"[enb-service] status: {st[-3:]}")
    if not (svc_right and svc_same and scan_right) or counts_svc["demap"] \
            or counts_svc["turbo_half_iteration"] <= 0 or iq_gap > ENB_IQ_TOL:
        raise AssertionError(f"[enb-service] {svc_right} {svc_same} "
                             f"{scan_right} {counts_svc} {svc['replies']}")
    t_split.append(time.perf_counter() - t_phase - sum(t_split) - svc_s)
    _reset_counts()
    t0 = time.perf_counter()
    ho = enb_handover(dev, ENB_HO_N_RB)
    ho_s = time.perf_counter() - t0
    counts_ho = _counts()
    print(f"[enb-handover] {ENB_HO_N_RB} PRB: {ho['checks']} in "
          f"{ho['ttis']} TTIs, {ho_s:.3f} s; launches {counts_ho} ({card})")
    _print_tti("1 UE, the reference's handover (attach, measurement, "
               "handover, user plane; UL and DL each TTI)", ho, card)
    if not all(ho["checks"].values()) or counts_ho["demap"]:
        raise AssertionError(f"[enb-handover] {ho} {counts_ho}")
    print(f"[enb] phase {time.perf_counter() - t_phase:.1f} s: user plane "
          f"and uplink, card and CPU {t_split[0]:.1f}, timed {t_split[1]:.1f},"
          f" profiled {t_split[2]:.1f}, service {svc_s:.1f}, CPU service and"
          f" scan {t_split[3]:.1f},"
          f" handover {ho_s:.1f} ({card})")
    launches = {k: counts_sim[k] + counts_timed[k] + counts_ho[k]
                for k in ("demap", "turbo_half_iteration", "host_reads")}
    summary = {name: {"n_ue": n_ue, "ttis": len(r["tti"]["times"]),
                      "tti_ms": _pct(r["tti"]["times"], 50),
                      "tti_p90_ms": _pct(r["tti"]["times"], 90),
                      "stage_ms": {k: v * 1e3 / len(r["tti"]["times"])
                                   for k, v in r["stages"].items()},
                      "reads_per_tti": float(np.mean(r["tti"]["reads"])),
                      "turbo_per_tti": float(np.mean(r["tti"]["turbo"])),
                      "turbo": sum(r["tti"]["turbo"])}
               for name, n_ue, r in (("lost_subframe", 1, lost),
                                     ("user_plane", 2, up2),
                                     ("handover", 1, ho))}
    return {"launches": launches, "service_launches": counts_svc,
            "timed": summary, "busy_share": busy, "device_ms": dev_ms,
            "service_s": svc_s, "service_ttis": svc["ttis"],
            "handover_s": ho_s, "handover_ttis": ho["ttis"],
            "handover_n_rb": ENB_HO_N_RB}


def run_harq_bench(card: str, harq: dict) -> dict:
    """``[harq-bench]``: the HARQ bench CLI at its defaults (B=384, 25 dB,
    bf16 IQ) on the card, counted; its JSON line printed after the tag,
    its ratio beside ``[harq]``'s."""
    _reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = harq_throughput.main([])
    counts = _counts()
    print(f"[harq-bench] {buf.getvalue().strip()}")
    print(f"[harq-bench] overhead ratio {res['overhead_ratio']:.3f} at "
          f"B={res['batch']} (bf16 IQ, {res['depth']} in flight) beside "
          f"[harq]'s {harq['ratio']:.3f} at B={HARQ_BATCH} (f32 IQ, in "
          f"turns); launches {counts} ({card})")
    if res["crc_ok"] != res["batch"] or res["single_crc_ok"] != res["batch"] \
            or res["unit"] != "Mbit/s/GPU" or counts["demap"] <= 0 or \
            counts["turbo_half_iteration"] <= 0:
        raise AssertionError(f"harq-bench: {res}, {counts}")
    return {**res, "launches": counts}


# -- slice I: the multi-device layer


def _shard_cases() -> list:
    """(name, sharded factory, single-device factory, arguments, keyword
    arguments, IQ, the rows sent) of ``[shard]``: each existing phase's
    configuration and seed at B = ``SHARD_B``."""
    cell, ul_cell = DlCell(), UlCell()
    iq_dl, tb_dl = dl_subframes(cell, SHARD_B, SNR_DB, seed=SEED)
    iq_ul, tb_ul = ul_subframes(ul_cell, SHARD_B, SNR_DB, seed=SEED)
    iq_h, tb_h, cells = harq_transmissions(
        cell, HARQ_SUBFRAMES, HARQ_RVS, SHARD_B, HARQ_SNR_DB, seed=SEED)
    iq_3, tb_3 = mimo_subframes(MIMO_TM3, SHARD_B, SNR_DB, "bench",
                                seed=SEED)
    iq_4, tb_4 = mimo_subframes(MIMO_TM4, SHARD_B, MIMO_TM4_SNR_DB, "corr",
                                seed=SEED)
    sp = shard_pipeline
    sic = {**MIMO_TM4.precoding, "tuning": DecoderTuning(mimo_detector="sic")}
    return [
        ("dl", sp.make_sharded_decoder, make_batch_decoder,
         cell.decoder_args(), {}, iq_dl, tb_dl),
        ("acquire", sp.make_sharded_acquire_decoder, make_batch_decoder,
         cell.decoder_args(), {}, iq_dl, tb_dl),
        ("ul", sp.make_sharded_pusch_decoder, make_pusch_batch_decoder,
         ul_cell.decoder_args(), {}, iq_ul, tb_ul),
        ("harq", sp.make_sharded_harq_decoder, make_batch_harq_decoder,
         harq_decoder_args(cells), {}, iq_h, tb_h),
        ("tm3_mmse", sp.make_sharded_mimo_decoder, make_mimo_batch_decoder,
         MIMO_TM3.decoder_args(), MIMO_TM3.precoding, iq_3,
         decoder_rows(tb_3)),
        ("tm4_sic", sp.make_sharded_mimo_decoder, make_mimo_batch_decoder,
         MIMO_TM4.decoder_args(), sic, iq_4, decoder_rows(tb_4))]


def pss_peak_f64(iq: np.ndarray, taps: np.ndarray) -> float:
    """max |sum_k x[n+k] conj(taps[k])| over the batch read as one capture,
    zeros past its end: one float64 FFT correlation."""
    x = (iq[..., 0] + 1j * iq[..., 1]).reshape(-1)
    m = 1 << int(np.ceil(np.log2(len(x) + len(taps) - 1)))
    y = np.fft.ifft(np.fft.fft(x, m) * np.conj(np.fft.fft(taps, m)))
    return float(np.abs(y[:len(x)]).max())


def run_shard(dev, card: str, caps: np.ndarray) -> dict:
    """``[shard]``: every sharded factory on an in-process NCCL group of
    one rank (a 1x1 mesh) at its phase's configuration, B = ``SHARD_B``:
    bits and flags equal to the single-device decoder's on the same IQ,
    n_ok = B, the turbo and demap kernels launched; the acquire decoder's
    pss_peak against a float64 correlation; the DL decoder timed sharded
    and not, in turns (the wrapper's cost); the sharded prescan of the
    native-rate captures ``caps`` equal to the one-device prescan."""
    t0 = time.perf_counter()
    cases = _shard_cases()
    print(f"[shard-gen] 6 configurations x {SHARD_B} subframes: "
          f"{time.perf_counter() - t0:.2f} s")
    out = {"cases": {}}
    with process_group(device=dev):
        mesh = make_mesh(1, 1, device=dev)
        backend = torch.distributed.get_backend()
        for name, make_s, make_1, args, kw, iq, rows in cases:
            x = torch.from_numpy(iq).to(dev)
            single = make_1(*args, **kw, device=dev)
            sharded = make_s(mesh, *args, **kw, device=dev)
            bits1, ok1, _ = single(x)
            torch.cuda.synchronize()
            _reset_counts()
            res = sharded(x)
            torch.cuda.synchronize()
            counts = _counts()
            bits, ok, n_ok = res[:3]
            same = torch.equal(bits, bits1) and torch.equal(ok, ok1)
            sent = np.array_equal(bits.cpu().numpy(), rows)
            line = (f"[shard] {name} 1x1 mesh ({backend}): n_ok {n_ok}/"
                    f"{len(rows)}, bits and flags equal the single-device "
                    f"decoder's: {same}, bits equal sent: {sent}; launches "
                    f"demap {counts['demap']}, turbo_half_iteration "
                    f"{counts['turbo_half_iteration']}")
            if name == "acquire":
                want = pss_peak_f64(iq, sync.pss_time_filters(
                    args[0])[args[1] % 3].astype(np.complex128))
                err = abs(res[3] - want) / want
                line += (f"; pss_peak {res[3]:.4f}, float64 {want:.4f}, "
                         f"rel err {err:.2e} (limit {SHARD_PEAK_TOL})")
                if err > SHARD_PEAK_TOL:
                    raise AssertionError(f"shard acquire: pss_peak "
                                         f"{res[3]} vs {want}")
                halo_ms = cuda_time_ms(lambda: sharded.acquire(x), 5)
                line += (f"; the halo correlation and its max all-reduce "
                         f"{halo_ms:.3f} ms (CUDA events) ({card})")
                out["halo_ms"] = halo_ms
            print(line)
            if not (same and sent and n_ok == len(rows)) or \
                    counts["demap"] <= 0 or \
                    counts["turbo_half_iteration"] <= 0:
                raise AssertionError(f"shard {name}: {line}")
            out["cases"][name] = {"n_ok": n_ok, "launches": counts}
            if name == "dl":
                # in turns, so that a change in the host's load meets both
                pairs = [(time_decode(sharded, x, 1)[0],
                          time_decode(single, x, 1)[0])
                         for _ in range(SHARD_REPS)]
                t_s, t_1 = (float(np.median(t)) for t in zip(*pairs))
                t_n = []
                for _ in range(SHARD_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    shard_pipeline.global_n_ok(ok, mesh)
                    t_n.append(time.perf_counter() - t0)
                t_n = float(np.median(t_n))
                print(f"[shard] dl B={SHARD_B}: 1-rank {backend} sharded "
                      f"{t_s * 1e3:.3f} ms, single-device {t_1 * 1e3:.3f} ms "
                      f"(medians, n={SHARD_REPS} each, in turns), ratio "
                      f"{t_s / t_1:.3f}; the n_ok all-reduce and its read "
                      f"alone {t_n * 1e3:.3f} ms ({card})")
                out["timing"] = {"sharded_ms": t_s * 1e3,
                                 "single_ms": t_1 * 1e3, "ratio": t_s / t_1,
                                 "n_ok_ms": t_n * 1e3, "batch": SHARD_B,
                                 "backend": backend}
            del x, single, sharded, res
        x = torch.from_numpy(caps).to(dev)
        one = batched_prescan(x, SCAN_CFG)
        _reset_counts()
        got = batched_prescan(x, SCAN_CFG, mesh=mesh)
        counts = _counts()
        same = _same_prescan(got, one)
        print(f"[shard] prescan 1x1 mesh ({backend}): {len(caps)} captures, "
              f"equal to the one-device prescan: {same}; launches "
              f"pss_corr_mag_bf16 {counts['pss_corr_mag_bf16']}")
        if not same or counts["pss_corr_mag_bf16"] <= 0:
            raise AssertionError(f"shard prescan: {got} vs {one}")
        out["cases"]["prescan"] = {"launches": counts}
    return out


def _native_captures(chans: list, dev) -> np.ndarray:
    """The channels read, resampled to the native rate on the card and
    trimmed to a common length: (n_chan, L) complex64 on the host."""
    caps = [scanner._native(ch, SCAN_CFG, dev) for ch in chans]
    n = min(c.shape[-1] for c in caps)
    return torch.stack([c[:n] for c in caps]).cpu().numpy()


def _same_prescan(got: list, want: list) -> bool:
    """Flags, roots and indices equal, peak ratios within 1e-5."""
    return len(got) == len(want) and all(
        (g["detected"], g["n_id_2"], g["pss_idx"])
        == (w["detected"], w["n_id_2"], w["pss_idx"])
        and abs(g["peak_ratio"] - w["peak_ratio"]) <= 1e-5 * w["peak_ratio"]
        for g, w in zip(got, want))


def run_shard_2rank(dev, card: str, caps: np.ndarray) -> dict:
    """``[shard-2rank]``: ``dryrun_multichip(2)`` with two gloo ranks that
    share cuda:0, on the 1x2 and 2x1 meshes (the acquire case at 100 PRB,
    MCS 28: its halo crosses the ranks), and the channel-sharded prescan of
    the native-rate captures ``caps``, equal to the one-device prescan;
    each rank's turbo, demap and PSS correlator launches counted in the
    rank.  Not a scaling number: the two ranks share one card."""
    one = batched_prescan(torch.from_numpy(caps).to(dev), SCAN_CFG)
    t0 = time.perf_counter()
    res = dryrun_multichip(2, device=dev.type, backend="gloo",
                           prescan=(SCAN_CFG, caps), verbose=False)
    wall = time.perf_counter() - t0
    for line in res[0].value["lines"]:
        print(f"[shard-2rank] rank 0: {line}")
    need = ("turbo_half_iteration", "demap", "pss_corr_mag_bf16")
    launches = [{k: r.launches[k] for k in need} for r in res]
    same = all(_same_prescan(d, one) for r in res
               for d in r.value["prescan"].values())
    print(f"[shard-2rank] 2 ranks on one card (cuda:0 shared, gloo; not a "
          f"scaling number): every case of both meshes on both ranks OK; "
          f"the sharded prescan of {len(caps)} captures equals the "
          f"one-device prescan on both meshes and ranks: {same}; launches by "
          f"rank {launches}; {wall:.1f} s with the ranks' start ({card})")
    if not same or any(c[k] <= 0 for c in launches for k in need):
        raise AssertionError(f"shard-2rank: prescan equal {same}, launches "
                             f"{launches}")
    summed = {k: sum(c[k] for c in launches) for k in need}
    return {"launches": summed, "by_rank": launches, "wall_s": wall,
            "lines": res[0].value["lines"]}


def run_scaling(dev, card: str) -> dict:
    """``[scaling]``: the scaling CLI with one rank (NCCL) at 100 PRB MCS
    28, ``SCALING_PER_DEV`` subframes: the 1-device baseline; its JSON line
    after the tag."""
    out = _run_cli(["lteax_torch.bench.scaling", "--nproc", "1",
                    "--per-dev", str(SCALING_PER_DEV), "--reps",
                    str(SCALING_REPS), "--device", dev.type])
    line = out.strip().splitlines()[-1]
    res = json.loads(line)
    print(f"[scaling] {line}")
    row = res["results"][0]
    if len(res["results"]) != 1 or row["n_ok"] != row["total_sf"] or \
            row["efficiency"] is not None or \
            row["launches"]["demap"] <= 0 or \
            row["launches"]["turbo_half_iteration"] <= 0:
        raise AssertionError(f"scaling: {res}")
    return {**row, "card": res["card"], "backend": res["backend"]}


def _same_report(got: dict, want: dict) -> bool:
    """Equal reports: every field equal, floats within 1e-5 relative (or
    1e-3 absolute)."""
    if got.keys() != want.keys():
        return False
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            if not isinstance(g, dict) or not _same_report(g, w):
                return False
        elif isinstance(w, float) and isinstance(g, (int, float)):
            if abs(g - w) > max(1e-3, 1e-5 * abs(w)):
                return False
        elif g != w:
            return False
    return True


def run_multihost(dev, card: str, chans: list, caps: list) -> dict:
    """``[multihost]``: ``apps.scanner --multihost 2 --prescan`` on 4 of
    the scanner phase's captures (at 20 Msps: each worker resamples on the
    card) with per-worker checkpoints in a temporary directory: each
    worker's reports equal the one-process scan's, both totals the live
    count; each worker's launches (from its standard error) counted."""
    one = scanner.scan_channels(chans, SCAN_CFG, prescan=True, device=dev)
    check_scan_reports(one, caps)
    n_live = sum(c is not None for c in caps)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmp = WORK / "multihost"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "lteax_torch.apps.scanner",
         *[f"{ch.label}={ch.path}:fc32:{ch.rate_hz}" for ch in chans],
         "--n-rb", str(SCAN_CFG.n_rb_dl), "--multihost", "2", "--prescan",
         "--checkpoint", str(tmp / "scan.ckpt"), "--port", str(port),
         "--device", dev.type],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode:
        raise AssertionError(f"multihost failed ({res.returncode}):\n"
                             f"{res.stdout}\n{res.stderr}")
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    reports = {d["channel"]: d for d in lines if "channel" in d}
    totals = sorted((d["worker"], d["multihost_total_cells"]) for d in lines
                    if "multihost_total_cells" in d)
    launches = [json.loads(ln)["launches"] for ln in res.stderr.splitlines()
                if ln.startswith('{"worker"')]
    owners = {d["channel"]: d["worker"] for d in reports.values()}
    same = len(reports) == len(one) and all(
        _same_report({k: v for k, v in reports[d["channel"]].items()
                      if k != "worker"}, d) for d in one)
    summed = {k: sum(c[k] for c in launches) for k in launches[0]} \
        if launches else {}
    print(f"[multihost] 2 workers (gloo, sharing cuda:0), {len(chans)} "
          f"captures at {SDR_RATE / 1e6:.0f} Msps with --prescan: reports "
          f"equal the one-process scan's: {same}; channel owners {owners}; "
          f"totals {totals} (live {n_live}); launches summed over workers "
          f"{ {k: v for k, v in summed.items() if v} }; {wall:.1f} s with "
          f"the workers' start ({card})")
    want_owner = {ch.label: i % 2 for i, ch in enumerate(chans)}
    if not same or totals != [(0, n_live), (1, n_live)] or \
            owners != want_owner or len(launches) != 2 or \
            any(summed[k] <= 0 for k in ("resample_poly", "pss_corr_mag_bf16",
                                         "turbo_half_iteration")):
        raise AssertionError(f"multihost: {res.stdout}\n{res.stderr}")
    return {"launches": summed, "wall_s": wall, "totals": totals}


PHASE_SECONDS: dict = {}


def decode_forms(name: str, dec, x: torch.Tensor, tb_ref: np.ndarray,
                 want_ok: int | None, forms: tuple) -> dict:
    """One decode with every launch count set to 0 just before it and read
    just after; each kernel form in ``forms`` must have launched and
    ``want_ok`` blocks pass (None: any), every passing one with the bits
    sent."""
    reset_launch_counts()
    bits, ok, n_iter = dec(x)
    torch.cuda.synchronize()
    counts = {f: c for f, c in launch_counts().items() if c}
    n_ok = int(ok.sum())
    okn = ok.cpu().numpy()
    bits_ok = bool(np.array_equal(bits.cpu().numpy()[okn], tb_ref[okn]))
    print(f"[bf16] {name}: crc ok {n_ok}/{len(tb_ref)}, bits of those equal "
          f"sent: {bits_ok}, n_iter {n_iter}, retries "
          f"{dec.last_stats.retries}, launches {counts}")
    if (want_ok is not None and n_ok != want_ok) or not bits_ok:
        raise AssertionError(f"[bf16] {name}: {n_ok}/{len(tb_ref)} decoded, "
                             f"{want_ok} expected (bits equal: {bits_ok})")
    for f in forms:
        if counts.get(f, 0) <= 0:
            raise AssertionError(f"[bf16] {name} never launched {f}")
    return {"n_ok": n_ok, "n_iter": n_iter, "launches": counts,
            "bits": bits}


def run_bf16(cell: DlCell, ul_cell: UlCell, dev, card: str) -> dict:
    """``[bf16]``: the reference's shipped numerics (``SHIPPED``) beside
    the f32 default on the same IQ."""
    f32 = DecoderTuning()
    k1, k3 = "turbo_half_iteration_bf16", "demap_bf16"
    out = {}
    # the DL headline: the SHIPPED decode is the bf16 forms' main path
    iq, tb = dl_subframes(cell, BATCH, SNR_DB, seed=SEED)
    x = torch.from_numpy(iq).to(dev)
    dec_s = make_batch_decoder(*cell.decoder_args(), tuning=SHIPPED,
                               device=dev)
    dec_f = make_batch_decoder(*cell.decoder_args(), tuning=f32, device=dev)
    sh = decode_forms("DL headline SHIPPED", dec_s, x, tb, BATCH, (k1, k3))
    fl = decode_forms("DL headline f32", dec_f, x, tb, BATCH,
                      ("turbo_half_iteration", "demap"))
    if not torch.equal(sh.pop("bits"), fl.pop("bits")):
        raise AssertionError("[bf16] SHIPPED and f32 bits differ")
    pairs = [(time_decode(dec_s, x, 1)[0], time_decode(dec_f, x, 1)[0])
             for _ in range(BF16_REPS)]
    t_s, t_f = (float(np.median(t)) for t in zip(*pairs))
    mb = lambda t: BATCH * cell.geom.tbs / t / 1e6
    print(f"[bf16] DL headline B={BATCH}, {SNR_DB} dB, in turns (n="
          f"{BF16_REPS} each): SHIPPED {t_s * 1e3:.3f} ms = {mb(t_s):.2f} "
          f"Mbit/s, n_iter {sh['n_iter']}; f32 {t_f * 1e3:.3f} ms = "
          f"{mb(t_f):.2f} Mbit/s, n_iter {fl['n_iter']}; ratio "
          f"{t_s / t_f:.3f}; bits equal ({card})")
    out["dl"] = {"shipped": {**sh, "ms": t_s * 1e3, "mbit_per_s": mb(t_s)},
                 "f32": {**fl, "ms": t_f * 1e3, "mbit_per_s": mb(t_f)}}
    launches = {k1: sh["launches"][k1], k3: sh["launches"][k3]}
    # the other trellis forms, on 64 of the same subframes (bf16_f32store:
    # the bf16 kernel, the extrinsic carried in f32)
    xs = x[:BF16_B]
    for name, t, form in (
            ("bf16_f32store",
             dataclasses.replace(SHIPPED, mdtype="bf16_f32store"), k1),
            ("bf16_freeze", dataclasses.replace(SHIPPED, pinpad=False),
             "turbo_half_iteration_bf16_freeze")):
        r = decode_forms(f"DL B={BF16_B} {name}", make_batch_decoder(
            *cell.decoder_args(), tuning=t, device=dev), xs, tb[:BF16_B],
            BF16_B, (form,))
        if form != k1:
            launches[form] = r["launches"][form]
    del x, xs
    # the threshold cells, both profiles on one IQ each
    out["threshold"] = {}
    for snr in BF16_THRESHOLD_DB:
        iq, tb = dl_subframes(cell, BATCH, snr, seed=SEED)
        x = torch.from_numpy(iq).to(dev)
        r = {p: decode_forms(f"DL {snr} dB {p}", d, x, tb, None, ())
             for p, d in (("shipped", dec_s), ("f32", dec_f))}
        out["threshold"][snr] = {p: {k: v[k] for k in ("n_ok", "n_iter")}
                                 for p, v in r.items()}
        del x
    print(f"[bf16] threshold cells, CRC ok of {BATCH} (n_iter): " + "; ".join(
        f"{snr} dB SHIPPED {v['shipped']['n_ok']} ({v['shipped']['n_iter']})"
        f", f32 {v['f32']['n_ok']} ({v['f32']['n_iter']})"
        for snr, v in out["threshold"].items()) + f" ({card})")
    # the other decoders at B=64 under SHIPPED, f32 on the same IQ
    iq, tb = ul_subframes(ul_cell, BF16_B, SNR_DB, seed=SEED)
    # (name, factory, args, keywords, IQ, sent rows, forms, CRC passes
    # required: all but at HARQ's 15 dB, where rv 0 + 2 is near threshold)
    cases = [("UL", make_pusch_batch_decoder, ul_cell.decoder_args(), {},
              torch.from_numpy(iq), tb, (k1, k3), len(tb))]
    iq, tb, cells = harq_transmissions(cell, HARQ_SUBFRAMES, HARQ_RVS,
                                       BF16_B, HARQ_SNR_DB, seed=SEED)
    cases.append((f"HARQ {HARQ_SNR_DB} dB", make_batch_harq_decoder,
                  harq_decoder_args(cells), {}, torch.from_numpy(iq), tb,
                  (k1, k3), None))
    iq, tb = mimo_subframes(MIMO_TM3, BF16_B, SNR_DB, "bench", seed=SEED)
    cases.append(("TM3 MMSE", make_mimo_batch_decoder,
                  MIMO_TM3.decoder_args(), {}, torch.from_numpy(iq),
                  decoder_rows(tb), (k1, k3), 2 * BF16_B))
    iq, tb = mimo_subframes(MIMO_TM4, BF16_B, MIMO_TM4_SNR_DB, "corr",
                            seed=SEED)
    cases.append(("TM4 SIC", make_mimo_batch_decoder,
                  MIMO_TM4.decoder_args(),
                  {**MIMO_TM4.precoding, "sic": True}, torch.from_numpy(iq),
                  decoder_rows(tb), (k1, "demap_bf16_out"), 2 * BF16_B))
    del iq
    out["b64"] = {}
    for name, make, args, kw, x, tb, forms, want in cases:
        x = x.to(dev)
        kw = dict(kw)
        sic = kw.pop("sic", False)
        tune = lambda t: dataclasses.replace(t, mimo_detector="sic") \
            if sic else t
        r_s = decode_forms(f"{name} B={BF16_B} SHIPPED", make(
            *args, **kw, tuning=tune(SHIPPED), device=dev), x, tb, want,
            forms)
        r_f = decode_forms(f"{name} B={BF16_B} f32", make(
            *args, **kw, tuning=tune(f32), device=dev), x, tb, None, ())
        out["b64"][name] = {"shipped": r_s["n_ok"], "f32": r_f["n_ok"],
                            "n_iter": [r_s["n_iter"], r_f["n_iter"]]}
        if name == "TM4 SIC":
            launches["demap_bf16_out"] = r_s["launches"]["demap_bf16_out"]
        if name == "UL":
            launches["demap_bf16 (UL shape)"] = r_s["launches"][k3]
    print(f"[bf16] B={BF16_B} under SHIPPED (f32), CRC ok: " + ", ".join(
        f"{k} {v['shipped']} ({v['f32']})" for k, v in out["b64"].items())
        + f" ({card})")
    out["launches"] = launches
    return out


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall time kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) \
        + time.perf_counter() - t0
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (the port's smoke run "
                         "has no CPU fallback)")
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    # 1. build
    t0 = time.perf_counter()
    lib = library()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in lib.ptxas_log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    print(f"[build] nvcc sm_90a: {build_s:.2f} s ({lib.path.name}; {card})")
    for ln in regs:
        print(f"[build] {ln}")

    # 2. each kernel against its plain version at the main paths' shapes
    cell, ul_cell = DlCell(), UlCell()
    cfg = cell.cfg
    dl_sgn, _ = dl_demap_plans(cfg, cell.re_idx, cell.geom, seq.pdsch_c_init(
        cell.rnti, cell.subframe, cell.n_cell_id))
    ul_dec = make_pusch_batch_decoder(*ul_cell.decoder_args(), device="cpu")
    demap_ul = timed("check_demap", check_demap, "demap (UL shape)",
                     ul_dec.ul_front.sgn.numpy(), ul_cell.alloc.n_re,
                     ul_cell.alloc.scheme, dev)
    turbo_mimo = timed("check_turbo", check_turbo_mimo, dev)
    turbo_si = timed("check_turbo", check_turbo_si, dev)
    turbo_attach = timed("check_turbo", check_turbo_attach, dev)
    turbo_forms = timed("check_turbo", check_turbo_forms, cell, dev)
    # SIC's front (f32 in, bf16 out) at TM4's shape, with codeword 0's
    # scrambling signs (pad columns emit 0: the de-match's zero slot)
    g4 = MIMO_TM4.geom
    sic_sgn = demap_mod.planar_sgn_np(
        seq.pdsch_c_init(MIMO_TM4.rnti, MIMO_TM4.subframe,
                         MIMO_TM4.n_cell_id, 0), g4.g, g4.qm,
        -(-g4.n_re // 128) * 128)
    bf = torch.bfloat16
    demap_forms = [
        timed("check_demap", check_demap, "demap_bf16", dl_sgn,
              cfg.n_sym_subframe * cfg.n_sc, cell.scheme, dev, bf, bf),
        timed("check_demap", check_demap, "demap_bf16 (UL shape)",
              ul_dec.ul_front.sgn.numpy(), ul_cell.alloc.n_re,
              ul_cell.alloc.scheme, dev, bf, bf),
        timed("check_demap", check_demap, "demap_bf16_out", sic_sgn,
              g4.n_re, MIMO_TM4.scheme, dev, torch.float32, bf)]
    kernels = [timed("check_demap", check_demap, "demap", dl_sgn,
                     cfg.n_sym_subframe * cfg.n_sc, cell.scheme, dev),
               timed("check_turbo", check_turbo, cell, dev),
               *timed("check_pss", check_pss, dev),
               timed("check_resample", check_resample),
               timed("check_acs_probe", check_acs_probe, dev)]
    k1 = turbo_forms[0]
    print(f"[kernel] turbo_half_iteration_bf16 {k1['shape']}, its variants "
          f"in turns, bit-exact vs plain: " + "; ".join(
              f"{var} {turbo_mod.BF16_VARIANTS[var]}: {ms:.4f} ms = "
              f"{ms / k1['bound_ms']:.2f}x the bound"
              for var, ms in k1["variant_ms"].items())
          + f"; the f32 form {k1['f32_same_run_ms']:.4f} ms; bound "
          f"{k1['bound_ms']:.4f} ms by {k1['bound_by']} ({card})")
    for k in [*kernels, demap_ul, *turbo_forms, *demap_forms]:
        if "by_shape" in k:             # the resampler: a line a shape below
            continue
        lib_ms = k["library_ms"]
        how = (f"within {k['max_rel_err_of_peak']:.2e} of the peak (limit "
               f"{k['tolerance_of_peak']}), root and index equal"
               if "tolerance_of_peak" in k else "bit-exact")
        print(f"[kernel] {k['name']} {k['shape']}: {how} vs plain; "
              f"kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
              f"({k['bytes'] / 1e6:.1f} MB, {k['ops'] / 1e9:.2f} G "
              f"operations), library call "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} ({card})")
    k6 = next(k for k in kernels if k["name"] == "resample_poly")
    for r in k6["by_shape"]:
        print(f"[kernel] resample_poly {r['shape']}: bit-exact vs plain; "
              f"kernel warm {r['ms']:.4f} ms, cold {r['cold_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}; conv1d TF32 off {r['library_ms']:.4f} ms, on "
              f"{r['library_tf32_ms']:.4f} ms ({card})")
    print(f"[kernel] turbo_half_iteration at the MIMO shape "
          f"{turbo_mimo['shape']}: bit-exact vs plain; kernel "
          f"{turbo_mimo['ms']:.4f} ms, plain {turbo_mimo['plain_ms']:.4f} ms, "
          f"bound {turbo_mimo['bound_ms']:.4f} ms by {turbo_mimo['bound_by']} "
          f"({turbo_mimo['bytes'] / 1e6:.1f} MB, {turbo_mimo['ops'] / 1e9:.2f}"
          f" G operations) ({card})")
    print(f"[kernel] turbo_half_iteration at the SI shapes {TURBO_SI}: "
          f"bit-exact vs plain; kernel at {turbo_si['shape']} "
          f"{turbo_si['ms']:.4f} ms a call back to back, device time "
          f"{_ms(turbo_si['device_ms'])} (profiler), plain "
          f"{turbo_si['plain_ms']:.4f} ms, "
          f"bound {turbo_si['bound_ms']:.6f} ms by {turbo_si['bound_by']} "
          f"({turbo_si['bytes'] / 1e3:.1f} kB, {turbo_si['ops'] / 1e6:.3f} M "
          f"operations) ({card})")
    print(f"[kernel] turbo_half_iteration at the attach shapes C=1, K "
          f"{ATTACH_K}, win 32: bit-exact vs plain; kernel at "
          f"{turbo_attach['shape']} {turbo_attach['ms']:.4f} ms a call back "
          f"to back, device time {_ms(turbo_attach['device_ms'])} "
          f"(profiler), plain {turbo_attach['plain_ms']:.4f} ms, bound "
          f"{turbo_attach['bound_ms']:.6f} ms by {turbo_attach['bound_by']} "
          f"({turbo_attach['bytes'] / 1e3:.1f} kB, "
          f"{turbo_attach['ops'] / 1e6:.3f} M operations) ({card})")
    print(f"[kernel] demap (UL shape) is also the MIMO decoders' launch: "
          f"(256, 14400) 64QAM, npad 14464, one a codeword ({card})")
    acs = kernels[-1]
    print(f"[kernel] acs_probe bf16 (packed pairs): bit-exact vs plain at "
          f"{PROBE_ROUNDS} rounds; kernel {acs['bf16_ms']:.4f} ms, plain "
          f"{acs['bf16_plain_ms']:.4f} ms, bound {acs['bf16_bound_ms']:.4f} "
          f"ms by {acs['bf16_bound_by']}; f32 {acs['tops']:.2f} and bf16 "
          f"{acs['bf16_tops']:.2f} T add/max per s, ratio "
          f"{acs['bf16_over_f32']:.3f} ({card})")

    # 3. the main paths, each with its launch counts
    dl = timed("dl", run_dl, cell, dev, card)
    launches = dict(dl["launches"])
    scan_out = timed("scanner", run_scanner, dev, card)
    launches.update(scan_out["launches"])
    si_out = timed("si", run_si, dev, card)
    sweep = timed("sweep", run_sweep, dev, card)
    launches["pss_detect_bf16"] = sweep["launches"]
    launches["pss_detect"] = sweep["f32"]["launches"]
    ul = timed("ul", run_ul, ul_cell, dev, card)
    wrap = timed("dl_wrap", run_dl_wrap, dev, card)
    harq = timed("harq", run_harq, cell, dev, card)
    probe = timed("probe", run_probe, dev, card)
    mimo_out = timed("mimo", run_mimo, dev, card)
    ctrl = timed("ctrl", run_ctrl, dev, card)
    ul_single = timed("ul_single", run_ul_single, dev, card)
    ul_bench = timed("ul_bench", run_ul_bench, card)
    bler = timed("bler", run_bler, dev, card)
    cfg3 = timed("config3", run_config3, dev, card)
    loop = timed("loopback", run_loopback, dev, card)
    stream = timed("stream", run_stream, dev, card)
    iq_out = timed("iq", run_iq, dev, card)
    trace_out = timed("trace", run_trace, card)
    ulctrl = timed("ulctrl", run_ulctrl, dev, card)
    attach = timed("attach", run_attach, dev, card)
    enb = timed("enb", run_enb, dev, card)
    harq_bench = timed("harq_bench", run_harq_bench, card, harq)
    chans4 = scan_out["chans"][SHARD_CHANS]
    caps4 = _native_captures(chans4, dev)
    shard = timed("shard", run_shard, dev, card, caps4)
    shard2 = timed("shard_2rank", run_shard_2rank, dev, card, caps4)
    scaling = timed("scaling", run_scaling, dev, card)
    multihost = timed("multihost", run_multihost, dev, card, chans4,
                      scan_out["caps"][SHARD_CHANS])
    bf16 = timed("bf16", run_bf16, cell, ul_cell, dev, card)
    launches.update(bf16["launches"])
    print("[phases] seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items())
        + f"; main {time.perf_counter() - t_start:.1f} in all")
    launches["acs_probe"] = probe["launches"]
    launches["demap (UL shape)"] = ul["launches"]["demap"]
    by_path = {name: {"dl": dl["launches"][name], "ul": ul["launches"][name],
                      "harq": harq["launches"][name],
                      "mimo": mimo_out["tm3"]["launches"][name],
                      "mimo_sic": mimo_out["tm4_sic"]["launches"][name],
                      "dl_wrap": wrap["launches"][name],
                      "si": si_out["launches"][name]}
               for name in ("demap", "turbo_half_iteration")}
    by_path["turbo_half_iteration"]["scanner"] = scan_out["turbo_launches"]
    by_path["demap"]["scanner"] = scan_out["demap_launches"]
    for name, c in (("ctrl", ctrl["launches"]),
                    ("ul_single", ul_single["ul-single"]["launches"]),
                    ("ul_uci", ul_single["ul-uci"]["launches"]),
                    ("ul_bench", ul_bench["launches"]),
                    ("bler", bler["launches"]),
                    ("config3", cfg3["launches"]),
                    ("loopback", loop["launches"]),
                    ("stream", stream["launches"]),
                    ("iq_f32", iq_out["launches"]["f32"]),
                    ("iq_bf16", iq_out["launches"]["bf16"]),
                    ("iq_sc8", iq_out["launches"]["sc8"]),
                    ("iq_prefetch", iq_out["prefetch_launches"]),
                    ("trace", trace_out["launches"]),
                    ("ulctrl", ulctrl["launches"]),
                    ("attach", attach["launches"]),
                    ("rrc_attach", attach["rrc_launches"]),
                    ("enb", enb["launches"]),
                    ("enb_service", enb["service_launches"]),
                    ("harq_bench", harq_bench["launches"])):
        for kernel in ("demap", "turbo_half_iteration"):
            by_path[kernel][name] = c[kernel]
    for kernel in ("demap", "turbo_half_iteration"):
        by_path[kernel]["shard"] = sum(v["launches"][kernel] for v
                                       in shard["cases"].values())
        for name, c in (("shard_2rank", shard2["launches"]),
                        ("scaling", scaling["launches"]),
                        ("multihost", multihost["launches"])):
            by_path[kernel][name] = c[kernel]
    by_path["resample_poly"] = {
        "scanner": scan_out["launches"]["resample_poly"],
        "si": si_out["launches"]["resample_poly"],
        "scanner_captures": scan_out["capture_launches"],
        "si_captures": si_out["capture_launches"],
        "multihost": multihost["launches"]["resample_poly"]}
    by_path["pss_corr_mag_bf16"] = {
        "scanner": scan_out["launches"]["pss_corr_mag_bf16"],
        "si": si_out["launches"]["pss_corr_mag_bf16"],
        **{name: c["pss_corr_mag_bf16"] for name, c in
           (("config3", cfg3["launches"]), ("loopback", loop["launches"]),
            ("stream", stream["launches"]),
            ("shard", shard["cases"]["prescan"]["launches"]),
            ("shard_2rank", shard2["launches"]),
            ("multihost", multihost["launches"]))}}

    extra = ("bytes", "ops", "shape", "tops", "bf16_over_f32", "library",
             "max_rel_err_of_peak", "sum_rel_err", "tolerance_of_peak",
             "peaks_moved_vs_f32", "cold_ms", "library_tf32_ms", "by_shape",
             "f32_ops", "bound_nofma_ms", "library_bf16_ms", "variant_ms",
             "f32_same_run_ms")
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": SOURCES[k["name"]][0],
         "replaces": SOURCES[k["name"]][1], "launches": launches[k["name"]],
         **({"launches_by_path": by_path[k["name"]]}
            if k["name"] in by_path else {}),
         **{key: k[key] for key in k
            if key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by", "library_ms") + extra
            or key.startswith("bf16_")}}
        for k in [*kernels, demap_ul, *turbo_forms, *demap_forms]],
        "bf16_profile": {key: bf16[key] for key in
                         ("dl", "threshold", "b64")},
        "demap_ul_shape": {key: demap_ul[key] for key in
                           ("shape", "ms", "plain_ms", "bound_ms",
                            "bound_by", "max_abs_err")},
        "turbo_mimo_shape": {key: turbo_mimo[key] for key in
                             ("shape", "ms", "plain_ms", "bound_ms",
                              "bound_by", "max_abs_err")},
        "turbo_si_shape": {key: turbo_si[key] for key in
                           ("shape", "ms", "device_ms", "plain_ms",
                            "bound_ms", "bound_by", "max_abs_err")},
        "turbo_attach_shape": {key: turbo_attach[key] for key in
                               ("shape", "ms", "device_ms", "plain_ms",
                                "bound_ms", "bound_by", "max_abs_err")},
        "ulctrl": {key: ulctrl[key] for key in
                   ("bursts", "detect_ms", "detect_device_ms",
                    "detect_kernels", "pucch_ok", "pucch_ms", "srs_ms")},
        "attach": {key: attach[key] for key in
                   ("card_wall_s", "cpu_wall_s", "rrc_wall_s", "tb_ms")},
        "enb": {key: enb[key] for key in
                ("timed", "busy_share", "device_ms", "service_s",
                 "service_ttis", "handover_s", "handover_ttis",
                 "handover_n_rb")},
        "turbo_enb_shape": {key: enb["turbo"][key] for key in
                            ("shapes", "shape", "ms", "device_ms",
                             "plain_ms", "bound_ms", "bound_by",
                             "max_abs_err")},
        "shard": shard, "shard_2rank": {key: shard2[key] for key in
                                        ("launches", "by_rank", "wall_s")},
        "scaling": scaling, "multihost": multihost,
        "harq_bench": {key: harq_bench[key] for key in
                       ("value", "unit", "single_rv_mbps", "overhead_ratio",
                        "combined_ms", "single_ms", "crc_ok", "batch",
                        "depth", "iq")},
        "si": {key: si_out[key] for key in
               ("wall_ms_per_channel", "first_wall_ms_per_channel",
                "stages", "reads", "launches")},
        "ctrl": {key: ctrl[key] for key in
                 ("dcis", "hi_bits", "blind_decode_ms", "wall_ms",
                  "host_reads")},
        "ul_single": {name: {key: v[key] for key in
                             ("n_ok", "ms_per_subframe", "turbo_per_subframe")}
                      for name, v in ul_single.items()},
        "ul_bench": {key: ul_bench[key] for key in
                     ("value", "unit", "vs_baseline", "crc_ok", "n_iter",
                      "batch")},
        "bler": {"gates": bler["gates"], "config2": bler["config2"]},
        "config3": {key: cfg3[key] for key in
                    ("noise_ratio", "ls_mse", "mmse_mse")},
        "dl_wrap": {key: wrap[key] for key in
                    ("cycles", "decode_ms", "decode_p90_ms", "mbit_per_s",
                     "front_ms", "n_iter", "syncs", "retries", "peak_gb")},
        "loopback": {key: loop[key] for key in ("cases", "generate")},
        "stream": {key: stream[key] for key in
                   ("windows", "window_sf", "ms_per_window", "msps",
                    "read_mb_s", "tcp_msps", "tcp_dropped", "status_reads",
                    "recorder_ms")},
        "iq": {key: iq_out[key] for key in
               (*IQ_FORMATS, "prefetch_ms", "copy_then_decode_ms")},
        "trace": {key: trace_out[key] for key in
                  ("events", "decode_batch_ranges", "kernels")},
        "scan_si_cost": scan_out["si_cost"],
        "scan_turbo_launches": scan_out["turbo_launches"],
        "mimo": {
            "tm3": {key: mimo_out["tm3"][key] for key in
                    ("decode_ms", "decode_p90_ms", "mbit_per_s", "front_ms",
                     "peak_gb", "n_iter", "syncs", "retries", "n_ok",
                     "reencode_ms")},
            "tm4_mmse": {key: mimo_out["tm4_mmse"][key] for key in
                         ("n_ok", "decode_ms", "mbit_per_s", "n_iter",
                          "peak_gb")},
            "tm4_sic": {key: mimo_out["tm4_sic"][key] for key in
                        ("n_ok", "decode_ms", "mbit_per_s", "n_iter", "syncs",
                         "peak_gb", "front_ms", "turbo0_ms", "cancel_ms",
                         "reencode_ms", "turbo1_ms")}},
        "decode_ms": dl["decode_ms"], "decode_p90_ms": dl["decode_p90_ms"],
        "mbit_per_s": dl["mbit_per_s"], "peak_gb": dl["peak_gb"],
        "n_iter": dl["n_iter"], "syncs": dl["syncs"],
        "front_ms": dl["front_ms"],
        "ul": {key: ul[key] for key in
               ("decode_ms", "decode_p90_ms", "mbit_per_s", "front_ms",
                "peak_gb", "n_iter", "syncs", "retries")},
        "harq": {key: harq[key] for key in
                 ("snr_db", "combined_ms", "single_ms", "ratio", "n_iter",
                  "combined_front_ms", "single_front_ms")},
        "probe": {"f32_ms": probe["f32"]["ms"], "bf16_ms": probe["bf16"]["ms"],
                  "f32_tops": probe["f32"]["tops"],
                  "bf16_tops": probe["bf16"]["tops"],
                  "ratio": probe["ratio"]},
        "scan_ms_per_channel": scan_out["wall_s"] * 1e3 / (N_LIVE + N_DEAD),
        "scan_stage_s": scan_out["stages"],
        "scan_host_reads": scan_out["reads"],
        "find_pss_f32_idx_moved": scan_out["find_pss_f32_idx_moved"],
        "sweep_ms": sweep["median_ms"], "sweep_msps": sweep["msps"],
        "sweep_f32_ms": sweep["f32"]["median_ms"],
        "sweep_f32_msps": sweep["f32"]["msps"],
        "sweep_moved_vs_f32": sweep["moved_vs_f32"],
        "build_s": build_s, "phase_s": PHASE_SECONDS, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
