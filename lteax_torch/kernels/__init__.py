"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU Pallas kernel
(demap, turbo half-iteration, PSS correlator and detect, polyphase
resampler, ACS op-mix probe), and the turbo decoder's glue between
half-iterations, which the reference leaves to XLA; each beside its plain
torch version and a launch counter.

A wrapper runs the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  The kernels are built with nvcc
at first use (``_build``) — never at import.
"""


def launch_counts() -> dict:
    """Each kernel form's launch count in this process (the counters a
    caller sets to 0, :func:`reset_launch_counts`), by the names
    ``chip_smoke.py`` reports: the turbo half-iteration's and the demap's
    other forms are ``turbo_half_iteration_<form>`` and ``demap_<form>``."""
    from lteax_torch.kernels import (acs_probe, demap, polyphase, pss,
                                     turbo_mlm)
    return {"demap": demap.LAUNCHES,
            **{f"demap_{f}": c for f, c in demap.FORM_LAUNCHES.items()},
            "turbo_half_iteration": turbo_mlm.LAUNCHES,
            **{f"turbo_half_iteration_{f}": c
               for f, c in turbo_mlm.FORM_LAUNCHES.items()},
            "turbo_glue": turbo_mlm.GLUE_LAUNCHES,
            "pss_corr_mag": pss.CORR_LAUNCHES,
            "pss_corr_mag_bf16": pss.CORR_BF16_LAUNCHES,
            "pss_detect": pss.DETECT_LAUNCHES,
            "pss_detect_bf16": pss.DETECT_BF16_LAUNCHES,
            "resample_poly": polyphase.LAUNCHES,
            "acs_probe": acs_probe.LAUNCHES}


def reset_launch_counts() -> None:
    """Set every kernel form's launch count in this process to 0."""
    from lteax_torch.kernels import (acs_probe, demap, polyphase, pss,
                                     turbo_mlm)
    demap.LAUNCHES = turbo_mlm.LAUNCHES = polyphase.LAUNCHES = 0
    turbo_mlm.GLUE_LAUNCHES = 0
    acs_probe.LAUNCHES = 0
    pss.CORR_LAUNCHES = pss.CORR_BF16_LAUNCHES = 0
    pss.DETECT_LAUNCHES = pss.DETECT_BF16_LAUNCHES = 0
    for forms in (demap.FORM_LAUNCHES, turbo_mlm.FORM_LAUNCHES):
        for f in forms:
            forms[f] = 0
