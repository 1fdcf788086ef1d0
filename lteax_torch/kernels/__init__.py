"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU Pallas kernel
(demap, turbo half-iteration, PSS correlator and detect, polyphase
resampler, ACS op-mix probe), each beside its plain torch version and a
launch counter.

A wrapper runs the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  The kernels are built with nvcc
at first use (``_build``) — never at import.
"""
