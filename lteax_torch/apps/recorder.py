"""IQ recorder: capture a sample stream to file with ctrl-socket control;
counterpart of ``lteax.apps.recorder``.

The source is a file or pipe, read and converted chunk by chunk by the
native double-buffered reader (``io.native.IqStream``), or live IQ over
TCP (``io.native.IqTcpSource``) with its overrun count.  Pure host IO: no
device is involved.

    python -m lteax_torch.apps.recorder --in-path /dev/stdin --out rec.fc32 \\
        --in-fmt sc8 --samples 1920000 [--earfcn N] [--ctrl-port 20001]
"""

from __future__ import annotations

import argparse
import sys
import threading

import numpy as np

from lteax_torch.apps.ctrl import CtrlServer
from lteax_torch.io import native
from lteax_torch.io.iq import from_iq_f32, write_iq


def record(in_path: str, out_path: str, in_fmt: str = "fc32",
           out_fmt: str = "fc32", n_samples: int = -1,
           chunk: int = 1 << 18, earfcn: int | None = None,
           progress=None) -> int:
    """Stream-convert ``n_samples`` (-1 = all) from in_path to out_path
    through the native reader.  Returns the number of complex samples
    recorded."""
    total = 0
    out_chunks = []
    with native.IqStream(in_path, in_fmt, chunk_samples=chunk) as stream:
        for block in stream:
            if n_samples >= 0 and total + len(block) > n_samples:
                block = block[: n_samples - total]
            out_chunks.append(from_iq_f32(block))
            total += len(block)
            if progress:
                progress(total)
            if n_samples >= 0 and total >= n_samples:
                break
    x = np.concatenate(out_chunks) if out_chunks else np.zeros(0, np.complex64)
    write_iq(out_path, x, out_fmt)
    return total


def record_tcp(src, out_path: str, n_samples: int, out_fmt: str = "fc32",
               chunk: int = 1 << 18, timeout_ms: int = 5000,
               progress=None) -> tuple[int, int]:
    """Record ``n_samples`` from a live ``native.IqTcpSource`` into a
    file.  Returns (samples_recorded, overrun_drop_count) — the drop
    counter is the reference's radio-overrun accounting equivalent."""
    out_chunks = []
    total = 0
    while total < n_samples:
        block = src.read(min(chunk, n_samples - total),
                         timeout_ms=timeout_ms)
        if not len(block):
            break
        out_chunks.append(block)
        total += len(block)
        if progress:
            progress(total)
    x = (np.concatenate(out_chunks) if out_chunks
         else np.zeros(0, np.complex64))
    write_iq(out_path, x, out_fmt)
    return total, src.dropped


def ctrl_recorder(in_path: str, out_path: str, in_fmt: str = "fc32",
                  out_fmt: str = "fc32", n_samples: int = -1,
                  earfcn: int | None = None, port: int = 20001
                  ) -> tuple[CtrlServer, threading.Event]:
    """A ctrl socket with ``read`` / ``write`` of ``earfcn``, ``samples``
    and ``recording``, and a ``record`` verb that records and then sets
    the returned event.  The caller stops the server."""
    params = {"earfcn": earfcn or 0, "samples": n_samples,
              "recording": False}
    done = threading.Event()

    def do_record(_args):
        params["recording"] = True
        n = record(in_path, out_path, in_fmt, out_fmt, params["samples"])
        params["recording"] = False
        done.set()
        return f"recorded {n}"

    return CtrlServer(params, {"record": do_record}, port=port), done


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="IQ stream recorder")
    p.add_argument("--in-path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--in-fmt", choices=("fc32", "sc8", "sc16"), default="fc32")
    p.add_argument("--out-fmt", choices=("fc32", "sc8"), default="fc32")
    p.add_argument("--samples", type=int, default=-1)
    p.add_argument("--earfcn", type=int, default=None)
    p.add_argument("--ctrl-port", type=int, default=None,
                   help="expose read/write/record ctrl socket and wait")
    a = p.parse_args(argv)
    if a.ctrl_port is not None:
        srv, done = ctrl_recorder(a.in_path, a.out, a.in_fmt, a.out_fmt,
                                  a.samples, a.earfcn, a.ctrl_port)
        print(f"ctrl on port {srv.port}; send 'record' to start",
              file=sys.stderr, flush=True)
        try:
            done.wait()
        finally:
            srv.stop()
    else:
        n = record(a.in_path, a.out, a.in_fmt, a.out_fmt, a.samples,
                   earfcn=a.earfcn)
        print(f"recorded {n} samples to {a.out}")


if __name__ == "__main__":
    main()
