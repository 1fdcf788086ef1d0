"""The decode bench CLIs (``lteax_torch.bench.dl_throughput``,
``ul_throughput``, ``mimo_throughput``, ``harq_throughput``): on the CPU a dry run, labelled so in its unit and
card, that decodes the bench configuration; without a card and without
``--device cpu`` they raise instead of measuring the CPU."""

import pytest
import torch

from lteax_torch.bench import (dl_throughput, harq_throughput,
                               mimo_throughput, ul_throughput)
from lteax_torch.bench.timing import NUMERICS
from lteax_torch.phy.tuning import SHIPPED

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


@pytest.mark.parametrize("bench,n_tb", [(dl_throughput, 1),
                                        (ul_throughput, 1),
                                        (mimo_throughput, 2),
                                        (harq_throughput, 1)],
                         ids=["dl", "ul", "mimo", "harq"])
def test_benches_take_the_shipped_numerics(bench, n_tb):
    """``--mdtype bf16 --demap-in bf16 --ofdm-dft factored``: the
    reference's shipped numerics (``SHIPPED``), named in the line."""
    out = bench.main(["--batch", "1", "--reps", "1", "--device", "cpu",
                      "--mdtype", "bf16", "--demap-in", "bf16",
                      "--ofdm-dft", "factored",
                      *(["--depth", "1"] if bench is harq_throughput
                        else [])])
    _dry_run(out, n_tb)
    assert {f: out[f] for f in NUMERICS} == {
        f: getattr(SHIPPED, f) for f in NUMERICS}


@pytest.mark.parametrize("bench", [dl_throughput, ul_throughput],
                         ids=["dl", "ul"])
def test_benches_take_the_turbo_knobs(bench):
    """``--nofreeze --combine-bf16 --planar-int8`` on the shipped numerics:
    the reference's ``LTEAX_PALLAS_NOFREEZE``, ``LTEAX_COMBINE_BF16`` and
    ``LTEAX_PLANAR_INT8``, named in the line."""
    out = bench.main(["--batch", "1", "--reps", "1", "--device", "cpu",
                      "--mdtype", "bf16", "--demap-in", "bf16",
                      "--nofreeze", "--combine-bf16", "--planar-int8"])
    _dry_run(out, 1)
    assert (out["nofreeze"], out["combine_bf16"], out["planar_int8"]) == \
        (True, True, True)


@pytest.mark.parametrize("ul_dft", ["factored", "matmul"])
def test_ul_bench_takes_the_ul_dft(ul_dft):
    """``--ul-dft``: the UL front's transform de-precoding, named in the
    line (the bench's signal is precoded by the FFT: the forms compute one
    transform)."""
    out = ul_throughput.main(["--batch", "1", "--reps", "1", "--device",
                              "cpu", "--ul-dft", ul_dft])
    _dry_run(out, 1)
    assert out["ul_dft"] == ul_dft


# A turbo kernel's SASS as ``cuobjdump -sass`` prints it, cut down: an
# acquisition loop (exchange only), a store loop (exchange and a shared
# store) in two compiled versions, a combine loop (exchange and a fold),
# an outer loop around the combine (not innermost) and a staging loop (no
# shuffle); encodings left out.
_SASS = """
		Function : _ZN4_GLOBAL_17turbo_half_kernelEPKf
        /*0000*/                   MOV R1, R2 ;
        /*0010*/                   FADD R3, R3, R4 ;
        /*0020*/                   SHFL.BFLY PT, R3, R3, R9, 0x1f ;
        /*0030*/              @P0 BRA 0x10 ;
        /*0040*/                   STS [R5], R3 ;
        /*0050*/                   SHFL.BFLY PT, R3, R3, R9, 0x1f ;
        /*0060*/                   NOP ;
        /*0070*/              @P1 BRA 0x40 ;
        /*0080*/                   STS.64 [R5], R2 ;
        /*0090*/                   FMNMX R3, R3, R4, !PT ;
        /*00a0*/                   SHFL.BFLY PT, R3, R3, R9, 0x1f ;
        /*00b0*/              @P1 BRA 0x80 ;
        /*00c0*/                   SHFL.BFLY PT, R3, R3, R9, 0x1f ;
        /*00d0*/                   SHFL.BFLY PT, R6, R6, 0x3, 0x1f ;
        /*00e0*/              @P2 BRA 0xc0 ;
        /*00f0*/              @P3 BRA 0xc0 ;
        /*0100*/                   LDG.E R7, desc[UR4][R10.64] ;
        /*0110*/              @P4 BRA 0x100 ;
        /*0120*/                   EXIT ;
"""


def test_turbo_sass_issue_model():
    """``turbo_variants --sass``: the trellis loops found by phase, and the
    warp instructions a launch they give."""
    from lteax_torch.bench import turbo_variants as tv
    funcs = tv.sass_functions(_SASS)
    (body,) = funcs.values()
    assert len(body) == 19
    loops = tv.trellis_loops(body)
    assert loops == {"acq": [[3, 1]], "store": [[3, 1], [4, 1]],
                     "combine": [[3, 1]]}
    m = tv.issue_model(loops, 4, 100, 32, 8, 4, 1)
    assert m["instr_per_step"] == {"acq": [3.0, 3.0], "store": [3.0, 4.0],
                                   "combine": [3.0, 3.0]}
    # 4 windows a row in one block of one warp; 8, 16 and 18 steps
    assert m["warps"] == 4
    assert m["warp_instr"] == [4 * (8 * 3 + 16 * 3 + 18 * 3),
                               4 * (8 * 3 + 16 * 4 + 18 * 3)]
    # two codeblocks a lane halve the warps
    assert tv.issue_model(loops, 4, 100, 32, 8, 4, 2)["warps"] == 2

