"""The port's operator ctrl socket (``lteax_torch/apps/ctrl.py``), as
``tests/test_ctrl.py`` and ``tests/test_observability.py`` hold the
reference's: the read / write / help / shutdown command language and
callbacks, the debug-mask verbs over the port's event log, the JSON-lines
debug stream, and the same answers as the reference's server to the same
lines.  Every server binds port 0 and is stopped."""

import json
import socket
import time

import pytest

from lteax.apps.ctrl import CtrlServer as RefCtrlServer

from lteax_torch.apps.ctrl import CtrlServer, DebugStreamServer
from lteax_torch.utils.metrics import EVENTS, EventLog, ctrl_debug_verbs


def _cmd(port, line):
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(line.encode() + b"\n")
        return s.makefile().readline().strip()


def test_read_write_commands():
    params = {"band": 1, "dl_earfcn": 300, "enable_pcap": False}
    scans = []
    srv = CtrlServer(params, {"scan": lambda a: scans.append(a) or "started"},
                     port=0)
    try:
        assert srv.port > 0
        assert _cmd(srv.port, "read dl_earfcn") == "ok dl_earfcn = 300"
        assert _cmd(srv.port, "write dl_earfcn 1950").startswith("ok")
        assert params["dl_earfcn"] == 1950
        assert _cmd(srv.port, "write enable_pcap on").startswith("ok")
        assert params["enable_pcap"] is True
        assert _cmd(srv.port, "write band x") == "error bad value for band"
        assert _cmd(srv.port, "scan 300 301") == "ok started"
        assert scans == [["300", "301"]]
        assert "commands:" in _cmd(srv.port, "help")
        assert _cmd(srv.port, "read nope").startswith("error")
        assert _cmd(srv.port, "bogus").startswith("error")
        assert _cmd(srv.port, "shutdown") == "ok shutting down"
    finally:
        srv.stop()


def test_same_answers_as_the_reference():
    lines = ["read a", "write a 7", "read a", "write b false", "read b",
             "help", "", "read", "write a", "boom 1", "echo x y", "nope"]

    def boom(_):
        raise ValueError("bad")

    answers = []
    for cls in (CtrlServer, RefCtrlServer):
        srv = cls({"a": 3, "b": True}, {"echo": lambda a: "+".join(a),
                                        "boom": boom}, port=0)
        try:
            answers.append([_cmd(srv.port, ln) for ln in lines])
        finally:
            srv.stop()
    assert answers[0] == answers[1]
    assert answers[0][-3:] == ["error ValueError: bad", "ok x+y",
                               "error unknown command nope"]


def test_debug_verbs_toggle_masks():
    ev = EventLog(level="info")
    srv = CtrlServer({}, ctrl_debug_verbs(ev), port=0)
    try:
        assert _cmd(srv.port, "debug_level") == "ok debug_level = info"
        assert _cmd(srv.port, "debug_level debug").endswith("= debug")
        assert ev.level == "debug"
        assert _cmd(srv.port, "debug_level bogus").startswith("error")
        assert _cmd(srv.port, "debug_types scan,enb").endswith("= enb,scan")
        assert ev.types == {"scan", "enb"}
        assert _cmd(srv.port, "debug_types all").endswith("= all")
        assert ev.types is None
    finally:
        srv.stop()


@pytest.mark.parametrize("own_log", [True, False])
def test_debug_stream_pushes_events(own_log):
    ev = EventLog(level="debug") if own_log else EVENTS
    dbg = DebugStreamServer(events=ev if own_log else None, port=0)
    try:
        assert dbg.events is ev
        with socket.create_connection(("127.0.0.1", dbg.port),
                                      timeout=5) as c:
            deadline = time.time() + 5
            while not dbg._conns and time.time() < deadline:
                time.sleep(0.05)                # accept loop registration
            ev.emit("scan.cell", n_cell_id=321)
            rec = json.loads(c.makefile().readline())
            assert rec["event"] == "scan.cell" and rec["n_cell_id"] == 321
    finally:
        dbg.stop()
    assert dbg._push not in ev._subs
