"""Rows that carry two transport blocks (``codewords`` 2, the contract of
``benchmark/systems``), on the CPU: a stub system runs through the
harness, the inputs and checks of the one-codeword cells are those they
were before the harness took codewords, and the K1/K2 reader counts every
codeword's codeblocks."""

import contextlib
import hashlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, faults, run, spec, window
from benchmark.systems import dl_sch
from benchmark.tests.test_benchmark_harness import _dry_run
from benchmark.traffic import make_inputs

SEED = 2147483659
CPU = torch.device("cpu")


class _TwoSubframes:
    """Each row two ``dl20_mcs28`` DL subframes, codeword q in subframe q,
    decoded by the port's DL-SCH decoder as one flattened (2B, n_samps, 2)
    batch: its outputs are b-major in (subframe, codeword)."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def last_stats(self):
        return self.inner.last_stats

    def front(self, x):
        return self.inner.front(x.reshape(-1, *x.shape[2:]))

    def turbo(self, llr):
        return self.inner.turbo(llr)

    def __call__(self, x):
        return self.turbo(self.front(x))


class _Swapped(_TwoSubframes):
    """The same, with the two codewords' output rows swapped."""

    def turbo(self, llr):
        bits, ok, n_iter = self.inner.turbo(llr)
        return (bits.reshape(-1, 2, bits.shape[-1]).flip(1).reshape(
            bits.shape), ok.reshape(-1, 2).flip(1).reshape(-1), n_iter)


def _stub(dec_class=_TwoSubframes):
    def transmit(cfg, tb):
        rows, n, tbs = tb.shape
        return dl_sch.transmit(cfg, tb.reshape(rows * n, tbs)).reshape(
            rows, n, -1)

    return SimpleNamespace(
        codewords=2, geometry=dl_sch.geometry,
        transmit=transmit,
        reference_front=lambda cfg, iq: dl_sch.reference_front(
            cfg, iq.reshape(-1, *iq.shape[2:])),
        decoder=lambda cfg, tuning, device: dec_class(
            dl_sch.decoder(cfg, tuning, device)))


def _through_the_harness(system, fault=None):
    """make_inputs, the warm-up, Loop.window, program_side and compare at
    the dry run's sizes -> (record, checks against the clean DL limits)."""
    cfg = spec.config("dl20_mcs28")
    traffic = {**spec.traffic("closed_b1024_snr25"), **run.DRY_RUN}
    dec = system.decoder(cfg, cfg["tuning"], CPU)
    inputs = make_inputs(system, cfg, traffic, SEED, CPU)
    assert tuple(inputs.batches[0].shape[:2]) == (traffic["batch"], 2)
    assert inputs.sent_host.shape == (2 * traffic["batch"], cfg["tbs"])
    loop = window.Loop(dec, inputs, CPU)
    for i in range(traffic["noise_batches"]):
        loop.batch(i)
    keep, rows = check.sample(SEED, traffic)
    with (faults.planted(fault, dec, system.geometry(cfg).c) if fault
          else contextlib.nullcontext()):
        rec = loop.window(0.1, keep, spans=False)
    side = check.program_side(rec, inputs, rows, system.geometry(cfg).c,
                              spec.codewords(system))
    assert len(side["sent"]) == 2 * traffic["check_tbs"]
    numbers = check.compare(system, cfg, side)
    return rec, check.judged(numbers, spec.limits("dl20_mcs28.clean"))


def test_two_codewords_run_correct():
    rec, checks = _through_the_harness(_stub())
    assert check.correct(checks), checks
    assert rec.attempted == len(rec.latencies) * run.DRY_RUN["batch"] * 2
    assert rec.good == rec.attempted and rec.crc_false_pass == 0


@pytest.mark.parametrize("fault", faults.FAULTS + ("codewords_swapped",))
def test_two_codewords_each_fault_is_not_correct(fault):
    if fault == "codewords_swapped":
        _, checks = _through_the_harness(_stub(_Swapped))
    else:
        _, checks = _through_the_harness(_stub(), fault)
    assert not check.correct(checks), checks


# cell -> sha256 of make_inputs' sent_host and of its first noise batch at
# the dry run's sizes and SEED, and the dry run's checks at SEED, as they
# were before the harness took codewords
ONE_CODEWORD = {
    "dl20_mcs28.edge": (
        "67e11e678e2539aabde072ea912fddd7205e3c42955a716e47158dbecb3ce553",
        "26105237a950035a3d935aeb777ddbbb27db7052732a2afab2e41c4c0cf61297",
        {"llr_sign_gap": 0.0008472222222222222, "tb_lost": 0.0,
         "crc_false_pass": 0}),
    "dl20_mcs28.clean": (
        "67e11e678e2539aabde072ea912fddd7205e3c42955a716e47158dbecb3ce553",
        "7538316d4b201e5e90df283c0fb9e923985cbd94e1821f0c6ada7723ac615d71",
        {"llr_sign_gap": 6.944444444444444e-05, "tb_lost": 0.0,
         "crc_false_pass": 0}),
    "ul20_64qam.clean": (
        "67e11e678e2539aabde072ea912fddd7205e3c42955a716e47158dbecb3ce553",
        "9dbea91282c2e42fc44dd53107f3d799f0b4534229ba2bc2070ce665f3e4c452",
        {"llr_sign_gap": 1.1574074074074073e-05, "tb_lost": 0.0,
         "crc_false_pass": 0}),
}


@pytest.mark.parametrize("cell", sorted(ONE_CODEWORD))
def test_one_codeword_cells_read_what_they_read(cell):
    sent, noise, checks = ONE_CODEWORD[cell]
    w = spec.workload(spec.benchmark(), cell)
    cfg = spec.config(w["config"])
    traffic = {**spec.traffic(w["traffic"]), **run.DRY_RUN}
    inputs = make_inputs(spec.system(cfg), cfg, traffic, SEED, CPU)
    digest = lambda a: hashlib.sha256(a.tobytes()).hexdigest()
    assert digest(inputs.sent_host) == sent
    assert digest(inputs.batches[0].numpy()) == noise
    out = _dry_run(cell, 0, "--cpu-dry-run")
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert {k: c["value"] for k, c in result["checks"].items()} == checks


def _k12(codewords: int, batch: int) -> float:
    """The K1/K2 reader on a hand-written trace: two full-batch launches,
    two of a compacted retry at a quarter of the grid, and one unfused."""
    cfg = spec.config("dl20_mcs28")
    kernels = [("turbo_half_bf16_kernel<true>", (416, 1, 1), 2.0e-3),
               ("turbo_half_bf16_kernel<true>", (416, 1, 1), 2.1e-3),
               ("turbo_half_bf16_kernel<true>", (104, 1, 1), 0.7e-3),
               ("turbo_half_bf16_kernel<true>", (104, 1, 1), 0.6e-3),
               ("turbo_half_kernel<1>", (52, 1, 1), 0.9e-3),
               ("demap_kernel<float, float>", (99, 1, 1), 1.0)]
    system = SimpleNamespace(geometry=dl_sch.geometry, codewords=codewords)
    return spec.reader("k12_roofline_pct")(SimpleNamespace(
        cfg=cfg, traffic={"batch": batch}, system=system,
        trace={"kernels": kernels}))


def test_k12_reader_counts_every_codeword():
    from benchmark.counts import bound_s, turbo_half_work
    cfg = spec.config("dl20_mcs28")
    geom = dl_sch.geometry(cfg)
    full = 64 * 2 * geom.c
    bound = sum(bound_s(turbo_half_work(
        cbs, geom.k + 3, 128, 16, trellis)) for cbs, trellis in (
            (full, "bf16"), (full, "bf16"), (full // 4, "bf16"),
            (full // 4, "bf16"), (full, "f32")))
    expect = 100 * bound / (2.0e-3 + 2.1e-3 + 0.7e-3 + 0.6e-3 + 0.9e-3)
    assert _k12(2, 64) == pytest.approx(expect, rel=1e-12)
    assert _k12(2, 64) == pytest.approx(_k12(1, 128), rel=1e-12)
    assert _k12(1, 64) < 0.6 * _k12(2, 64)
