"""The ACS op-mix chain's plain torch version against the TPU probe kernel
(``bench/vpu_bf16_probe.py::_kernel`` through ``pl.pallas_call`` in interpret
mode), bit for bit, in f32 and bf16; the wrapper's CPU route and checks; the
probe's CLI on the CPU.  The CUDA kernel itself is held to the plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Bit-exact because every add and max rounds once to the working type on both
sides; at 64 rounds the positive lanes are ~1e26 (finite), the lanes with
both values negative are frozen at their start."""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lteax_torch.bench import acs_probe as probe_cli
from lteax_torch.kernels import acs_probe

_spec = importlib.util.spec_from_file_location(
    "vpu_bf16_probe", Path(__file__).resolve().parents[1] / "bench"
    / "vpu_bf16_probe.py")
ref_probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_probe)

SHAPE = (16, 128)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _reference(x32: np.ndarray, name: str, rounds: int) -> np.ndarray:
    """The TPU kernel in interpret mode -> float32 view of its output."""
    x = jnp.asarray(x32, dtype=JDT[name])
    f = pl.pallas_call(functools.partial(ref_probe._kernel, rounds=rounds),
                       out_shape=jax.ShapeDtypeStruct(SHAPE, JDT[name]),
                       interpret=True)
    return np.asarray(f(x).astype(jnp.float32))


@pytest.mark.parametrize("rounds", [8, 64])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_plain_matches_tpu_kernel(name, rounds):
    x32 = np.random.default_rng(rounds).standard_normal(SHAPE).astype(
        np.float32)
    ref = _reference(x32, name, rounds)
    x = torch.from_numpy(x32).to(TDT[name])
    before = acs_probe.LAUNCHES
    got = acs_probe.acs_chain(x, rounds)             # CPU: the plain version
    assert acs_probe.LAUNCHES == before
    assert got.dtype == TDT[name] and got.shape == SHAPE
    assert np.isfinite(ref).all() and np.abs(ref).max() > 1e3
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), ref)
    assert torch.equal(got, acs_probe.acs_chain_plain(x, rounds))


def test_chain_saturates_without_nan():
    """512 rounds: positive lanes reach inf, negative pairs stay put, and
    no inf - inf arises."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        SHAPE).astype(np.float32))
    for dt in TDT.values():
        out = acs_probe.acs_chain_plain(x.to(dt), 512)
        assert not torch.isnan(out).any()
        assert torch.isinf(out).any() and torch.isfinite(out).any()


def test_zero_rounds_is_identity_and_negative_raises():
    x = torch.randn(4, 6)
    assert torch.equal(acs_probe.acs_chain(x, 0), x)
    with pytest.raises(ValueError):
        acs_probe.acs_chain(x, -1)


def test_probe_cli_on_cpu(capsys):
    probe_cli.main(["--device", "cpu", "--programs", "1", "--rounds", "8",
                    "--reps", "2", "--scaling"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cpu")
    res = json.loads(lines[-1])
    assert list(res["scaling"]) == ["1", "2", "4", "8", "16"]
    assert sum(ln.startswith("rounds ") for ln in lines) == 5
    assert res["device"] == "cpu" and res["elements"] == 256 * 128
    assert res["ratio"] == pytest.approx(res["bf16"]["tops"]
                                         / res["f32"]["tops"])


def test_probe_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        probe_cli.run(rounds=8, reps=1, programs=1)
