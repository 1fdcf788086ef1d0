"""lteax_torch — the PyTorch / CUDA port of lteax for NVIDIA Hopper GPUs.

The JAX package ``lteax`` is the reference; this package mirrors its layout
so each counterpart is easy to find:

  phy/        receive chains in plain torch (OFDM, chest, equalizers, sync,
              PBCH, PCFICH, PDCCH / DCI, PHICH, PDSCH, PUSCH with UCI, CRC,
              rate de-match plans, turbo decode loop) with their numpy
              plans, configuration, grid maps and tables
  kernels/    hand-written CUDA kernels for sm_90a (demap, turbo
              half-iteration, PSS correlator and detect, polyphase
              resampler, ACS op-mix probe) with their plain torch versions
              and launch counters; sources under ``kernels/csrc``
  pipeline.py ``make_batch_decoder`` (DL-SCH), ``make_batch_harq_decoder``
              (HARQ-IR), ``make_pusch_batch_decoder`` (UL-SCH) and
              ``make_mimo_batch_decoder`` (2x2 TM3/TM4, MMSE or SIC): IQ ->
              TB bits, CRC flags
  apps/       the multi-carrier cell scanner to the MIB, SIBs and paging
              (one process, or workers in a gloo group), the capture
              generator and scanner CLIs (config #1), the streaming
              scanner, the recorder, the ctrl socket, the attach and eNB
              simulators
  shard/      the multi-device layer over torch.distributed: the rank
              mesh and its launcher, the halo exchange, the sharded
              decoders, the channel-sharded prescan, the multi-rank dry
              run
  sim/        DL, UL (with UCI), HARQ, 2x2 MIMO, cell and control-region
              test-signal generators
  bench/      DL, UL, MIMO and HARQ decode throughput, config #2's sweep
              and BLER gate, config #3's gates, the PSS sweep, the ACS
              probe, kernel studies, the scaling bench and the
              multi-process dry run
  io/ native/ IQ files and stagings, the native C++ readers and TCP
              ingest (built by g++ at first use)
  stack/ utils/  EARFCN helpers, the RRC codecs, checkpoint, metrics,
              tracing

The package imports torch and numpy, never jax and nothing of ``lteax``: it
keeps its own copy of every module it needs from there, and
``tests/test_torch_plans.py`` holds each copy equal to its original.  Entry
points run on the current CUDA device unless the caller names another.
"""

__version__ = "0.1.0"
