"""The port's streaming scanner and recorder on the CPU, as
``tests/test_stream_scan.py`` and ``tests/test_recorder.py`` hold the
reference's, at 6 PRB on the port's own captures (``apps/file_gen.py``):
windows and checkpoint resume, each window's report equal to the port's
``scan`` of that window, the ctrl socket's ``status`` / ``results`` /
``stop``, live TCP ingest (sc8), the CLI; the recorder's format
conversion, its ctrl ``record`` verb and ``record_tcp`` with its overrun
count.  Every socket binds port 0 and every server and source is
closed."""

import json
import socket
import threading

import numpy as np
import pytest
import torch

from lteax_torch.apps import recorder, stream_scan
from lteax_torch.apps.file_gen import GenConfig, generate
from lteax_torch.apps.file_scan import scan
from lteax_torch.apps.stream_scan import StreamScanService
from lteax_torch.io import native
from lteax_torch.io.iq import read_iq, to_iq_sc8, write_iq
from lteax_torch.phy.config import PhyConfig

CFG = PhyConfig(n_rb_dl=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """5 frames of cell 99: two windows of 20 subframes and 10 left."""
    x = generate(GenConfig(n_rb_dl=6, n_cell_id=99, n_frames=5),
                 device="cpu")
    path = str(tmp_path_factory.mktemp("stream") / "cap.fc32")
    write_iq(path, x)
    return path, x


def _cmd(port, line):
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(line.encode() + b"\n")
        return s.makefile().readline().strip()


def _sc8(x: np.ndarray) -> np.ndarray:
    return to_iq_sc8(x / (4 * np.max(np.abs(x)))).reshape(-1)


def test_windows_resume_and_reports_equal_scan(capture, tmp_path):
    path, x = capture
    ck = str(tmp_path / "ck.json")
    svc = StreamScanService(path, CFG, window_sf=20, ckpt_path=ck,
                            device="cpu")
    try:
        res = svc.run(max_windows=1)
        assert _cmd(svc.ctrl.port, "results 0")[3:] == json.dumps(res[0])
    finally:
        svc.stop()
    assert res[0]["n_cell_id"] == 99 and res[0]["sfn"] == 0
    # resume: w0 comes from the checkpoint, w1 is scanned; the 10 subframes
    # left (< 12 needed for MIB/SI headroom) end the run
    svc2 = StreamScanService(path, CFG, window_sf=20, ckpt_path=ck,
                             device="cpu")
    try:
        res2 = svc2.run()
    finally:
        svc2.stop()
    assert sorted(res2) == [0, 1] and res2[0] == res[0]
    assert res2[1]["n_cell_id"] == 99 and res2[1]["sfn"] == 2
    assert json.load(open(ck)).keys() == {"w0", "w1"}
    n = 20 * CFG.n_samps_subframe
    for w in (0, 1):
        want = json.loads(scan(x[w * n:(w + 1) * n], CFG,
                               device="cpu").to_json())
        assert res2[w] == {**want, "window": w}
        assert res2[w]["sib1"] is not None and res2[w]["sib_crc_fails"] == 0


def test_ctrl_status_and_stop(capture):
    path, _ = capture
    svc = StreamScanService(path, CFG, window_sf=20, device="cpu")
    try:
        st = json.loads(_cmd(svc.ctrl.port, "status")[3:])
        assert st == {"windows_done": 0, "window_sf": 20,
                      "last_cell_id": None, "running": True}
        assert "counters" in json.loads(_cmd(svc.ctrl.port, "metrics")[3:])
        assert _cmd(svc.ctrl.port, "debug_level").startswith("ok")
        assert _cmd(svc.ctrl.port, "stop") == "ok stopping"
        assert svc.run() == {}          # stopped before any window
        assert not json.loads(_cmd(svc.ctrl.port, "status")[3:])["running"]
    finally:
        svc.stop()


def test_live_tcp_ingest():
    """IQ streamed over TCP as sc8 in chunks, scanned window by window:
    the window's report equals the scan of the samples sent."""
    x = generate(GenConfig(n_rb_dl=6, n_cell_id=55, n_frames=4),
                 device="cpu")
    sc8 = _sc8(x)
    with native.IqTcpSource(fmt="sc8") as src:
        svc = StreamScanService(None, CFG, fmt="sc8", window_sf=40,
                                tcp_source=src, live_idle_s=2.0,
                                device="cpu")

        def sender():
            with socket.create_connection(("127.0.0.1", src.port),
                                          timeout=5) as c:
                for i in range(0, len(sc8), 8192):   # trickle in chunks
                    c.sendall(sc8[i:i + 8192].tobytes())

        t = threading.Thread(target=sender)
        t.start()
        try:
            results = svc.run(max_windows=1)
            st = svc.status()
        finally:
            t.join()
            svc.stop()
    assert results[0]["n_cell_id"] == 55
    assert results[0]["mib"]["n_rb_dl"] == 6
    assert st["live"] and st["overruns_dropped"] == 0
    sent = sc8.astype(np.float32).reshape(-1, 2) / 128.0
    want = scan(sent[:, 0] + 1j * sent[:, 1], CFG, device="cpu")
    assert results[0] == {**json.loads(want.to_json()), "window": 0}


def test_cli(capture, capsys, tmp_path):
    path, _ = capture
    ck = str(tmp_path / "ck.json")
    assert stream_scan.main([path, "--window-sf", "20", "--max-windows",
                             "1", "--checkpoint", ck,
                             "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("ctrl port ")
    assert json.loads(out[-1])["n_cell_id"] == 99
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stream_scan.main([path])


def test_recorder_convert(tmp_path):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100000)
         + 1j * rng.standard_normal(100000)).astype(np.complex64) * 0.1
    src, dst = str(tmp_path / "src.sc8"), str(tmp_path / "dst.fc32")
    write_iq(src, x, "sc8")
    n = recorder.record(src, dst, in_fmt="sc8", out_fmt="fc32",
                        n_samples=60000, chunk=1 << 14)
    assert n == 60000
    np.testing.assert_array_equal(read_iq(dst, "fc32"),
                                  read_iq(src, "sc8")[:60000])
    # all of it, through the CLI
    recorder.main(["--in-path", src, "--out", dst, "--in-fmt", "sc8"])
    np.testing.assert_array_equal(read_iq(dst, "fc32"), read_iq(src, "sc8"))


def test_recorder_ctrl_record(tmp_path):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(5000)
         + 1j * rng.standard_normal(5000)).astype(np.complex64) * 0.1
    src, dst = str(tmp_path / "s.fc32"), str(tmp_path / "d.fc32")
    write_iq(src, x, "fc32")
    srv, done = recorder.ctrl_recorder(src, dst, n_samples=5000, earfcn=300,
                                       port=0)
    try:
        assert _cmd(srv.port, "read earfcn") == "ok earfcn = 300"
        assert _cmd(srv.port, "write samples 4000") == "ok samples = 4000"
        assert _cmd(srv.port, "record") == "ok recorded 4000"
        assert done.is_set()
        assert _cmd(srv.port, "read recording") == "ok recording = False"
    finally:
        srv.stop()
    np.testing.assert_array_equal(read_iq(dst, "fc32"), x[:4000])


def test_record_tcp(tmp_path):
    """A capture streamed over TCP as sc8 is recorded with no drop, equal
    to the samples sent, and scans to its cell."""
    gc = GenConfig(n_rb_dl=6, n_cell_id=42, n_frames=2)
    x = generate(gc, device="cpu")
    sc8 = _sc8(x)
    out = str(tmp_path / "cap.fc32")
    with native.IqTcpSource(fmt="sc8") as src:
        def sender():
            with socket.create_connection(("127.0.0.1", src.port),
                                          timeout=5) as c:
                c.sendall(sc8.tobytes())
        t = threading.Thread(target=sender)
        t.start()
        try:
            n, dropped = recorder.record_tcp(src, out, n_samples=len(x))
        finally:
            t.join()
    assert n == len(x) and dropped == 0
    got = read_iq(out, "fc32")
    sent = sc8.astype(np.float32).reshape(-1, 2) / 128.0
    np.testing.assert_array_equal(got, sent[:, 0] + 1j * sent[:, 1])
    r = scan(got, gc.phy, device="cpu")
    assert r.n_cell_id == 42 and r.mib is not None
