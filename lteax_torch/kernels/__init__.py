"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU Pallas kernel
(demap, turbo half-iteration, PSS correlator and detect, polyphase
resampler, ACS op-mix probe), each beside its plain torch version and a
launch counter.

A wrapper runs the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  The kernels are built with nvcc
at first use (``_build``) — never at import.
"""


def launch_counts() -> dict:
    """Each kernel's launch count in this process (the counters a caller
    sets to 0), by the names ``chip_smoke.py`` reports."""
    from lteax_torch.kernels import (acs_probe, demap, polyphase, pss,
                                     turbo_mlm)
    return {"demap": demap.LAUNCHES,
            "turbo_half_iteration": turbo_mlm.LAUNCHES,
            "pss_corr_mag": pss.CORR_LAUNCHES,
            "pss_corr_mag_bf16": pss.CORR_BF16_LAUNCHES,
            "pss_detect": pss.DETECT_LAUNCHES,
            "pss_detect_bf16": pss.DETECT_BF16_LAUNCHES,
            "resample_poly": polyphase.LAUNCHES,
            "acs_probe": acs_probe.LAUNCHES}

