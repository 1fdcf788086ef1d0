"""Config #2 in the port (``lteax_torch.bench.snr_sweep``).

On the CPU, against the reference (``bench/snr_sweep.py``, imported inside
the tests so that this file collects without jax on the card):
``sweep(decoder="device")`` gives the reference's BER and BLER at 6 PRB
MCS 4 with 4 blocks at two points, seed 1 (one seed draws the same TB bits
and noise in both); the gate's parse of ``docs/bler_awgn.csv`` and its
points and bands equal ``tests/test_snr_sweep.py``'s.  The production
route (``decoder="pallas"``) and the CLI run as dry runs.

On the card (marker ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_snr_sweep.py``): the gate itself, the production
decoder's waterfall at the stored 6-PRB MCS 4 and 25-PRB MCS 10 curves
within the ±0.5 dB band, BER 0 at the zero + 0.5 dB point."""

import pytest
import torch

from lteax_torch.bench import snr_sweep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sweep_device_matches_the_reference():
    from bench.snr_sweep import sweep as sweep_ref
    kw = dict(n_rb=6, mcs=4, n_blocks=4, esn0_points=[-3.0, -1.0], n_iter=6,
              seed=1)
    tbs, scheme, got = snr_sweep.sweep(**kw, decoder="device", device="cpu")
    tbs_r, scheme_r, ref = sweep_ref(**kw, decoder="device")
    assert (tbs, scheme) == (tbs_r, scheme_r) == (408, "qpsk")
    assert got == ref, (got, ref)
    assert got[0][2] > 0.0 and got[1][2] == 0.0       # a waterfall


def test_gate_points_and_curves_match_the_reference_test():
    import test_snr_sweep as gate_ref
    curves = snr_sweep.stored_production_curves()
    assert curves == gate_ref._stored_production_curves()
    assert set(curves) == {(6, 4), (25, 10)}
    for curve in curves.values():
        assert snr_sweep.gate_points(curve) == gate_ref._gate_points(curve)
    assert (snr_sweep.GATE_MARGIN, snr_sweep.GATE_STEP) == \
        (gate_ref._MARGIN, gate_ref._STEP)


def test_production_route_and_cli_dry_run(capsys):
    """The production tail on the CPU: all 6 blocks lost far below the
    waterfall, none above it; the CLI prints the reference's CSV."""
    _, _, res = snr_sweep.sweep(n_rb=6, mcs=4, n_blocks=6,
                                esn0_points=[-6.0, 0.0], decoder="pallas",
                                device="cpu")
    assert res[0][2] == 1.0 and res[1][1:] == (0.0, 0.0)
    snr_sweep.main(["--n-rb", "6", "--mcs", "4", "--blocks", "2", "--device",
                    "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "esn0_db,ber,bler" and len(lines) == 8
    assert all(len(ln.split(",")) == 3 for ln in lines[1:])


def test_sweep_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        snr_sweep.sweep(n_rb=6, mcs=4, n_blocks=1, esn0_points=[0.0])
    with pytest.raises(ValueError):
        snr_sweep.sweep(n_rb=6, mcs=4, n_blocks=1, decoder="xla",
                        device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("n_rb,mcs,scheme", [(6, 4, "qpsk"),
                                             (25, 10, "16qam")])
def test_bler_gate_on_the_card(n_rb, mcs, scheme):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    out = snr_sweep.bler_gate(n_rb, mcs, device="cuda")
    assert out["scheme"] == scheme
    for s, lo, hi, bler, _ in out["points"]:
        assert lo <= bler <= hi, (s, lo, hi, bler, out)
    assert out["points"][-1][4] == 0.0
    assert out["ok"]
