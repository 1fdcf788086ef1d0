"""One module a system under test, named by a configuration's
``"system"``: how the benchmark builds the program's decoder for the
configuration, what the frozen transmitter sends it, the plain reference
of its front, and the shapes its kernels are counted at.

The contract a module keeps (``cfg`` the configuration's dict):

- ``codewords``: the transport blocks (TBs) one subframe row carries, an
  int; a module without it carries one.  With n codewords, every TB of a
  row has the same geometry, as a rank-2 grant at one MCS gives.
- ``geometry(cfg)``: one codeword's geometry (``benchmark.lte.Geometry``).
- ``transmit(cfg, tb)``: bits (rows, TBS) int8 with one codeword, (rows,
  n, TBS) with n -> one noiseless subframe row each, complex64, the row
  first (``benchmark/traffic.py`` adds the noise).
- ``decoder(cfg, tuning, device)``: the program's decoder.  Called on a
  batch of B subframe rows (dim 0 the subframe, as the harness keeps every
  batch) it returns (bits (B n, TBS) int8, CRC flags (B n,) bool, n_iter),
  the rows b-major in (subframe, codeword); its ``front(x)`` returns the
  de-matched LLRs (B n C, 3, K + 4) in the same order, its ``turbo``
  takes them, and ``last_stats`` holds the tail's ``TurboStats``.  A
  decoder that wants another layout maps to it in its own module.
- ``reference_front(cfg, iq)``: the plain reference of the front on S
  subframe rows -> (S n C, 3, K + 4) float64, in the same order.
- ``demap_columns(cfg)``: (symbols, planar columns) of one K3 launch's
  subframe.
"""
