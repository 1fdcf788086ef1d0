"""The port's native C++ IQ reader and TCP ingest (``lteax_torch/native``,
built here with g++ at first use), as ``tests/test_native_io.py`` holds
the reference's: reads with offset and count in fc32, sc8 and sc16 equal
the numpy reader (sc16: int16 / 32768), the prefetch stream's chunks
cover the file in order, and TCP ingest gives the samples sent and counts
what overflows its ring."""

import socket
import time

import numpy as np
import pytest

from lteax_torch.io import native
from lteax_torch.io.iq import read_iq, write_iq


def _x(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.1
            ).astype(np.complex64)


@pytest.mark.parametrize("fmt", ["fc32", "sc8", "sc16"])
def test_read_offset_and_count(tmp_path, fmt):
    x = _x(50000, 0)
    p = str(tmp_path / f"c.{fmt}")
    if fmt == "sc16":
        raw = np.round(np.stack([x.real, x.imag], -1) * 32767).astype(np.int16)
        raw.tofile(p)
        want = raw.astype(np.float32) / 32768.0
    else:
        write_iq(p, x, fmt)
        r = read_iq(p, fmt)
        want = np.stack([r.real, r.imag], -1)
    got = native.read_iq_native(p, fmt)
    assert got.shape == (50000, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.read_iq_native(p, fmt, count=1000, offset_samples=100),
        want[100:1100])
    np.testing.assert_array_equal(
        native.read_iq_native(p, fmt, offset_samples=49990), want[49990:])
    # a count past the end stops at the end
    assert native.read_iq_native(p, fmt, count=20,
                                 offset_samples=49995).shape == (5, 2)
    with pytest.raises(IOError):
        native.read_iq_native(str(tmp_path / "missing"), fmt, count=4)


def test_stream_chunks(tmp_path):
    x = _x(70001, 1)
    p = str(tmp_path / "s.fc32")
    write_iq(p, x, "fc32")
    with native.IqStream(p, "fc32", chunk_samples=8192) as s:
        chunks = [c.copy() for c in s]
    assert [len(c) for c in chunks] == [8192] * 8 + [70001 - 8 * 8192]
    got = np.concatenate(chunks)
    np.testing.assert_array_equal(got[:, 0] + 1j * got[:, 1], x)
    with pytest.raises(IOError):
        native.IqStream(str(tmp_path / "missing"))


def test_tcp_round_trip_and_overrun():
    with native.IqTcpSource(fmt="sc8", ring_samples=4096) as src:
        assert src.port > 0 and not src.connected
        with socket.create_connection(("127.0.0.1", src.port), timeout=5):
            pass                    # connect/disconnect must not wedge it
        data = np.arange(-64, 64, dtype=np.int8)          # 64 IQ pairs
        with socket.create_connection(("127.0.0.1", src.port),
                                      timeout=5) as c:
            c.sendall(data.tobytes())
            got = src.read(64, timeout_ms=2000)
            while len(got) < 64:
                more = src.read(64 - len(got), timeout_ms=2000)
                assert len(more), "timed out waiting for samples"
                got = np.concatenate([got, more])
            assert src.connected
            ref = data.astype(np.float32).reshape(-1, 2) / 128.0
            np.testing.assert_array_equal(
                np.stack([got.real, got.imag], -1), ref)
            assert src.dropped == 0
            # overrun: send far more than the ring holds without reading
            c.sendall(np.zeros(2 * 3 * 4096, np.int8).tobytes())
            deadline = time.time() + 5
            while src.dropped == 0 and time.time() < deadline:
                time.sleep(0.05)
            assert src.dropped > 0
            drained = 0
            while True:
                chunk = src.read(4096, timeout_ms=200)
                if not len(chunk):
                    break
                drained += len(chunk)
            assert drained > 0
            assert drained + src.dropped == 3 * 4096    # every sample once
    dropped = src.dropped
    assert dropped > 0 and len(src.read(8)) == 0      # closed: empty
