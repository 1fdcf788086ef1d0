"""The port's attach simulators (``lteax_torch.apps.attach_sim``,
``rrc_attach_sim``) against the reference's, on the CPU.

``_dl_sch`` / ``_ul_sch`` encode on the host exactly as the reference's
(the same numpy generator, drawn in the same order) and decode with the
port's single-subframe PDSCH / PUSCH receivers: from the same generator
state both carry the same bytes at TBS 256 and 1032, and leave the
generator in the same state.  Where the noise defeats the code both return
``None``; only ``None``-ness is compared there, because a failing block's
bits may differ (pinned vs frozen padding, ROADMAP §3).  The port's
``run`` of each simulator gives the dict the reference's own tests expect,
all True (the reference's ``run`` is not called here: its own tests do).

``pdsch_decode_llrs(..., n_iter, codeword)``, the reference's arguments,
is held to the reference's on codeword 1 at 5 iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lteax.apps import attach_sim as attach_ref
from lteax.phy.channels import pdsch as pdsch_ref
from lteax.phy.mod import demodulate_maxlog as demod_ref

from lteax_torch.apps import attach_sim, rrc_attach_sim
from lteax_torch.io import pcap
from lteax_torch.phy.channels import pdsch
from lteax_torch.phy.mod import demodulate_maxlog

NOISE = 10 ** (-1.2)          # the simulators' 12 dB
LOUD = 10 ** 0.3              # -3 dB: every block fails
# (link, TBS, noise, seed)
CASES = [("dl", 256, NOISE, 1), ("dl", 1032, NOISE, 2), ("ul", 256, NOISE, 3),
         ("ul", 1032, NOISE, 4), ("dl", 1032, LOUD, 5), ("ul", 1032, LOUD, 6)]


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """One torch thread; the reference's fft UL DFT (the port's form)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_UL_DFT", "fft")
    yield
    mp.undo()
    torch.set_num_threads(n)


def payload(tbs, seed):
    n = (tbs - 8 * (seed % 3)) // 8
    return np.random.default_rng(100 + seed).integers(0, 256, n).astype(
        np.uint8).tobytes()


@pytest.fixture(scope="module")
def reference(_setup):
    """Each case through the reference's ``_dl_sch`` / ``_ul_sch``: its
    result and the generator's state after it."""
    out = {}
    for link, tbs, noise, seed in CASES:
        rng = np.random.default_rng(seed)
        fn = attach_ref._dl_sch if link == "dl" else attach_ref._ul_sch
        got = fn(payload(tbs, seed), tbs, 0x3D, seed % 10, 214, noise, rng)
        out[seed] = (got, rng.bit_generator.state)
    return out


@pytest.mark.parametrize("link,tbs,noise,seed", CASES)
def test_sch_carries_the_reference_bytes(reference, link, tbs, noise, seed):
    rng = np.random.default_rng(seed)
    fn = attach_sim._dl_sch if link == "dl" else attach_sim._ul_sch
    got = fn(payload(tbs, seed), tbs, 0x3D, seed % 10, 214, noise, rng,
             device="cpu")
    want, state = reference[seed]
    assert rng.bit_generator.state == state
    if noise == LOUD:
        assert got is None and want is None
    else:
        assert got == want == payload(tbs, seed)


def test_pdsch_decode_llrs_codeword_and_iterations_as_the_reference():
    """Codeword 1's scrambling and 5 iterations: the encoder's symbols and
    the decode as the reference's; the receiver of codeword 0 fails."""
    rng = np.random.default_rng(9)
    tbs = 1032
    tb = rng.integers(0, 2, tbs).astype(np.int32)
    geom = pdsch.pdsch_geometry(tbs, tbs, 2, 0)
    geom_r = pdsch_ref.pdsch_geometry(tbs, tbs, 2, 0)
    sym = pdsch.pdsch_encode(tb, geom, 0x3D, 4, 214, "qpsk", codeword=1)
    np.testing.assert_allclose(
        sym, np.asarray(pdsch_ref.pdsch_encode(tb, geom_r, 0x3D, 4, 214,
                                               "qpsk", codeword=1)),
        rtol=0, atol=1e-6)
    rx = (sym + np.sqrt(NOISE / 2) * (rng.standard_normal(sym.shape)
                                      + 1j * rng.standard_normal(sym.shape))
          ).astype(np.complex64)
    llr = demodulate_maxlog(torch.from_numpy(rx), "qpsk", NOISE)
    got = pdsch.pdsch_decode_llrs(llr, geom, 0x3D, 4, 214, n_iter=5,
                                  codeword=1)
    want = pdsch_ref.pdsch_decode_llrs(demod_ref(jnp.asarray(rx), "qpsk",
                                                 NOISE),
                                       geom_r, 0x3D, 4, 214, n_iter=5,
                                       codeword=1)
    assert got[1] and want[1]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], tb)
    np.testing.assert_array_equal(got[2], want[2])
    assert not pdsch.pdsch_decode_llrs(llr, geom, 0x3D, 4, 214, n_iter=5)[1]


def test_attach_run_on_the_cpu(tmp_path):
    """The reference test's seven stages, all True, and the MAC pcap with
    the RAR and the user-plane PDU."""
    path = tmp_path / "attach.pcap"
    res = attach_sim.run(verbose=False, pcap_path=str(path), device="cpu")
    assert res == {"prach": True, "rar": True, "rrc_request": True,
                   "attach_request": True, "aka": True, "smc": True,
                   "bearer": True}
    raw = path.read_bytes()
    assert int.from_bytes(raw[20:24], "little") == pcap.LINKTYPE_USER1
    assert raw.count(bytes([pcap.FDD_RADIO, pcap.DIR_DL, pcap.RNTI_RA])) == 1


def test_rrc_attach_run_on_the_cpu():
    """The reference test's five stages (RACH, AS security, attach, user
    plane, handover with the target cell's dedicated RACH), all True."""
    res = rrc_attach_sim.run(verbose=False, device="cpu")
    assert res == {"rach": True, "as_security": True, "attach": True,
                   "user_plane": True, "handover": True}
