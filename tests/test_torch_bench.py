"""The decode bench CLIs (``lteax_torch.bench.dl_throughput``,
``ul_throughput``, ``mimo_throughput``, ``harq_throughput``): on the CPU a dry run, labelled so in its unit and
card, that decodes the bench configuration; without a card and without
``--device cpu`` they raise instead of measuring the CPU."""

import pytest
import torch

from lteax_torch.bench import (dl_throughput, harq_throughput,
                               mimo_throughput, ul_throughput)

torch.set_num_threads(1)


def _dry_run(out: dict, n_tb: int):
    assert out["unit"] == "Mbit/s/CPU (dry run)" and out["card"] == "cpu"
    assert out["crc_ok"] == n_tb and out["n_iter"] >= 1 and out["value"] > 0


def test_dl_bench_dry_run(capsys):
    out = dl_throughput.main(["--batch", "1", "--reps", "1",
                              "--device", "cpu"])
    _dry_run(out, 1)
    assert out["vs_baseline"] == round(out["value"] / 75.376, 3)
    assert '"vs_baseline"' in capsys.readouterr().out


@pytest.mark.parametrize("args", [[], ["--static-nv"]],
                         ids=["estimated_nv", "static_nv"])
def test_ul_bench_dry_run(args, capsys):
    out = ul_throughput.main(["--batch", "1", "--reps", "1", "--device",
                              "cpu", *args])
    _dry_run(out, 1)
    assert out["vs_baseline"] == round(out["value"] / 75.376, 3)
    assert out["batch"] == 1 and "UL-SCH" in out["metric"]
    assert '"Mbit/s/CPU (dry run)"' in capsys.readouterr().out


@pytest.mark.parametrize("args", [[], ["--detector", "sic", "--tm", "4",
                                        "--cmat", "corr", "--mcs", "24",
                                        "--snr-db", "28"]],
                         ids=["tm3_mmse", "tm4_sic"])
def test_mimo_bench_dry_run(args):
    out = mimo_throughput.main(["--batch", "1", "--reps", "1", "--device",
                                "cpu", *args])
    _dry_run(out, 2)
    assert out["batch"] == 1 and "dual-codeword" in out["metric"]


def test_harq_bench_dry_run(capsys):
    """The HARQ CLI at B=1: both decoders decode their block, and the
    line carries both rates and their overhead ratio."""
    out = harq_throughput.main(["--batch", "1", "--reps", "1", "--depth",
                                "1", "--device", "cpu"])
    _dry_run(out, 1)
    assert out["single_crc_ok"] == 1 and out["single_rv_mbps"] > 0
    assert out["overhead_ratio"] == round(out["combined_ms"]
                                          / out["single_ms"], 3)
    assert out["batch"] == 1 and "HARQ" in out["metric"]
    assert '"overhead_ratio"' in capsys.readouterr().out


@pytest.mark.parametrize("bench", [dl_throughput, ul_throughput,
                                   mimo_throughput, harq_throughput],
                         ids=["dl", "ul", "mimo", "harq"])
def test_benches_need_a_card(bench):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--batch", "1"])
