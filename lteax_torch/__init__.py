"""lteax_torch — the PyTorch / CUDA port of lteax for NVIDIA Hopper GPUs.

The JAX package ``lteax`` is the reference; this package mirrors its layout
so each counterpart is easy to find:

  phy/        PDSCH receive chain in plain torch (OFDM, chest, equalizer,
              CRC, rate de-match plans, turbo driver) and the numpy plan
              code it needs (copied from ``lteax`` modules that import jax)
  kernels/    hand-written CUDA kernels for sm_90a (demap, turbo
              half-iteration) with their plain torch versions and launch
              counters; sources under ``kernels/csrc``
  pipeline.py ``make_batch_decoder``: (B, n_samps, 2) IQ -> TB bits, CRC
  sim/        jax-free DL test-signal generator (the ``bench.py`` recipe)

The package imports torch and numpy and never jax.  It reuses the ``lteax``
modules that are jax-free at import time (``phy.config``, ``phy.tables``,
``phy.fec.segmentation``, ``phy.grid``, ``io.iq``).
"""

__version__ = "0.1.0"
