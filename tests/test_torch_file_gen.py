"""The port's ``apps/file_gen.py`` against ``lteax.apps.file_gen``: for each
listed ``GenConfig`` the port's ``generate`` (on the CPU) equals the
reference's within 1e-5 of the peak (orthonormal IFFTs that sum in other
orders), and the port's scan of it reports every SIB body it was sent with
no SI CRC failure.  The configs are the reference's loopback tests' (config
#1, extended CP, SIB3/5/9 in SI message 1, three SI messages in their own
windows, SIB12/13 in a 16-frame window, SI by DCI 1C with paging), at the
fewest frames that carry every message: 5 for the three-message schedule,
whose third message goes in frame 4.  The reference's OFDM is pinned to
its FFT route (``LTEAX_OFDM_DFT=fft``)."""

import dataclasses

import numpy as np
import pytest
import torch

from lteax.apps import file_gen as fg_ref
from lteax.stack import rrc as rrc_ref

from lteax_torch.apps import file_gen
from lteax_torch.apps.file_scan import scan
from lteax_torch.sim import cell_gen
from lteax_torch.stack import rrc


def _configs(r):
    """name -> (GenConfig keywords, extra SIB names) with ``r``'s SIBs."""
    s3 = r.Sib3(q_hyst_db=6, cell_resel_priority=5, q_rx_lev_min=-64)
    s5 = r.Sib5(carriers=(r.InterFreqCarrier(
        dl_earfcn=6400, cell_resel_priority=2,
        neigh_cells=(r.InterFreqNeighCell(17, 4),)),))
    s9 = r.Sib9(hnb_name=b"lteax-home")
    s12 = r.Sib12(message_identifier=0x1112, serial_number=0x3000,
                  warning_segment=b"CMAS TEST", data_coding_scheme=b"\x01")
    s13 = r.Sib13(areas=(r.MbsfnAreaInfo(mbsfn_area_id=9,
                                         sf_alloc_info=0b110000),))
    return {
        "config1": dict(n_rb_dl=6, n_cell_id=214, n_frames=4),
        "extended_cp": dict(n_rb_dl=6, n_cell_id=77, n_frames=4, tac=0xECB,
                            extended_cp=True),
        "extra_sibs": dict(n_rb_dl=6, n_cell_id=150, n_frames=4, tac=0xBEEF,
                           extra_sibs=(s3, s5, s9)),
        "multi_si": dict(n_rb_dl=6, n_cell_id=99, n_frames=5, tac=0xC0DE,
                         extra_sibs=(s3, s5, s9),
                         si_schedule=((8, (3,)), (8, (5,)), (8, (9,)))),
        "rel9_sibs": dict(n_rb_dl=6, n_cell_id=77, n_frames=4,
                          extra_sibs=(r.Sib3(), s12, s13),
                          si_schedule=((8, (3,)), (16, (12, 13)))),
        "dci_1c_paging": dict(n_rb_dl=6, n_cell_id=200, n_frames=4,
                              si_dci="1c",
                              paging_tmsi=(0xDEADBEEF, 0x1234ABCD)),
    }


@pytest.fixture(autouse=True, scope="module")
def _env():
    mp = pytest.MonkeyPatch()
    mp.setenv("LTEAX_OFDM_DFT", "fft")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    mp.undo()


@pytest.mark.parametrize("name", list(_configs(rrc)))
def test_generate_matches_reference_and_scans_back(name):
    kw = _configs(rrc)[name]
    gc = file_gen.GenConfig(**kw)
    x = file_gen.generate(gc, device="cpu")
    ref = np.asarray(fg_ref.generate(fg_ref.GenConfig(
        **_configs(rrc_ref)[name])))
    assert x.dtype == np.complex64
    assert x.shape == ref.shape == (10 * gc.n_frames
                                    * gc.phy.n_samps_subframe,)
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-5 * np.abs(ref).max())

    r = scan(x, gc.phy, device="cpu")
    assert (r.n_cell_id, r.n_ant, r.sib_crc_fails) == (gc.n_cell_id, 1, 0)
    assert r.mib is not None and r.sfn == 0
    assert r.sib1 == gc.sib1() and r.sib1.tac == gc.tac
    assert r.sib2 == rrc.Sib2()
    sent = {f"sib{cell_gen._sib_type(s)}": s for s in gc.extra_sibs}
    assert r.sibs == sent
    assert r.paging == ([hex(t) for t in gc.paging_tmsi]
                        if gc.paging_tmsi else None)
    if gc.si_schedule:
        assert tuple((e.si_periodicity_rf, e.sib_mapping)
                     for e in r.sib1.scheduling) == gc.si_schedule


def test_gen_config_fields_and_defaults_match_reference():
    """Every field of the reference's GenConfig, with its default; the
    port's adds only the MIB's PHICH duration (False, as file_gen sends)."""
    ref = {f.name: f.default for f in dataclasses.fields(fg_ref.GenConfig)}
    got = {f.name: f.default for f in dataclasses.fields(file_gen.GenConfig)}
    assert got.pop("phich_duration_extended") is False
    assert got == ref
    gc = file_gen.GenConfig(n_rb_dl=15, extended_cp=True, n_ant=2)
    assert (gc.phy.n_rb_dl, gc.phy.n_ant, gc.phy.n_sym_subframe) == (15, 2, 12)
    assert gc.ctrl_syms == 2


def test_extra_si_subframe_grid_matches_reference():
    """``build_subframe_grid`` with the reference's arguments, in the
    subframe that carries SI message 2 (frame 2, subframe 1)."""
    from lteax.phy.channels import pbch as pbch_ref
    import jax.numpy as jnp
    kw, kw_r = _configs(rrc)["multi_si"], _configs(rrc_ref)["multi_si"]
    gc, gc_r = file_gen.GenConfig(**kw), fg_ref.GenConfig(**kw_r)
    si = cell_gen.si_bits(gc)
    assert si.extra_at(2, 1) is si.si[1] and si.extra_at(4, 1) is si.si[2]
    assert si.extra_at(2, 2) is None and si.extra_at(10, 1) is si.si[1]
    gc = dataclasses.replace(gc, sib1_mcs=si.mcs)
    gc_r = dataclasses.replace(gc_r, sib1_mcs=si.mcs)
    mib = rrc.pack_mib(gc.mib(0))
    q = cell_gen.pbch.pbch_encode_40ms(mib, 1, gc.n_cell_id)
    q_r = np.asarray(pbch_ref.pbch_encode_40ms(jnp.asarray(mib), 1,
                                               gc.n_cell_id))
    args = (si.sib1, si.sib2, None, si.si[1])
    got = file_gen.build_subframe_grid(gc, 2, 1, q, *args)
    ref = fg_ref.build_subframe_grid(gc_r, 2, 1, q_r, *args)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert np.count_nonzero(got) > np.count_nonzero(
        file_gen.build_subframe_grid(gc, 2, 1, q, *args[:3]))
