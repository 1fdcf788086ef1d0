"""Operator control interface: TCP line-protocol server.

(reference capability: ``libtools/src/libtools_server_socket.cc`` +
``LTE_fdd_dl_scan_interface.cc`` / ``LTE_fdd_enb_interface.cc`` command
language — ``read <param>``, ``write <param> <value>``, ``start``, ``stop``,
``scan``, ``help``, ``shutdown`` on ctrl port 20000.)

A thin threaded TCP server over a parameter store + command callbacks; the
streaming scanner and the recorder expose their state and verbs through
it.  The port's own copy of ``lteax/apps/ctrl.py``, over the port's
``utils.metrics.EVENTS`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import socket
import threading


class CtrlServer:
    def __init__(self, params: dict, commands: dict | None = None,
                 host: str = "127.0.0.1", port: int = 20000):
        """params: name -> value store (read/write).
        commands: verb -> callable(args: list[str]) -> str."""
        self.params = params
        self.commands = commands or {}
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _handle_line(self, line: str) -> str:
        parts = line.strip().split()
        if not parts:
            return "error empty command"
        verb = parts[0].lower()
        if verb == "read":
            if len(parts) != 2:
                return "error usage: read <param>"
            if parts[1] not in self.params:
                return f"error unknown param {parts[1]}"
            return f"ok {parts[1]} = {self.params[parts[1]]}"
        if verb == "write":
            if len(parts) != 3:
                return "error usage: write <param> <value>"
            name, val = parts[1], parts[2]
            if name not in self.params:
                return f"error unknown param {name}"
            cur = self.params[name]
            try:
                self.params[name] = type(cur)(val) if not isinstance(cur, bool) \
                    else val.lower() in ("1", "true", "on")
            except ValueError:
                return f"error bad value for {name}"
            return f"ok {name} = {self.params[name]}"
        if verb == "help":
            cmds = ["read", "write", "help", "shutdown"] + list(self.commands)
            return "ok commands: " + " ".join(sorted(cmds)) \
                + "; params: " + " ".join(sorted(self.params))
        if verb == "shutdown":
            self._stop.set()
            return "ok shutting down"
        if verb in self.commands:
            try:
                return "ok " + str(self.commands[verb](parts[1:]))
            except Exception as e:
                return f"error {type(e).__name__}: {e}"
        return f"error unknown command {verb}"

    def _serve(self):
        self._srv.settimeout(0.2)
        conns: list[socket.socket] = []
        try:
            while not self._stop.is_set():
                try:
                    c, _ = self._srv.accept()
                except socket.timeout:
                    continue
                conns.append(c)
                threading.Thread(target=self._client, args=(c,),
                                 daemon=True).start()
        finally:
            for c in conns:
                try:
                    c.close()
                except OSError:
                    pass
            self._srv.close()

    def _client(self, conn: socket.socket):
        buf = b""
        with conn:
            while not self._stop.is_set():
                conn.settimeout(0.2)
                try:
                    data = conn.recv(4096)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    return
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    resp = self._handle_line(line.decode(errors="replace"))
                    try:
                        conn.sendall(resp.encode() + b"\n")
                    except OSError:
                        return

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)


class DebugStreamServer:
    """Debug message stream: pushes JSON-lines events to every connected
    client.

    (reference capability: ``LTE_fdd_enb_interface`` debug TCP port 20001
    with type/level masks — SURVEY.md §5.  The masks live on the
    ``EventLog`` and are toggled over the CTRL socket via
    ``lteax_torch.utils.metrics.ctrl_debug_verbs`` (``debug_level`` /
    ``debug_types`` verbs); this server is the transport.)"""

    def __init__(self, events=None, host: str = "127.0.0.1", port: int = 0):
        from lteax_torch.utils.metrics import EVENTS
        self.events = events or EVENTS
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self.events.subscribe(self._push)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _push(self, line: str) -> None:
        with self._lock:
            conns = list(self._conns)
        dead = []
        for c in conns:
            try:
                c.sendall(line.encode() + b"\n")
            except OSError:
                dead.append(c)
        if dead:
            with self._lock:
                for c in dead:
                    if c in self._conns:
                        self._conns.remove(c)
                    try:
                        c.close()
                    except OSError:
                        pass

    def _serve(self):
        self._srv.settimeout(0.2)
        try:
            while not self._stop.is_set():
                try:
                    c, _ = self._srv.accept()
                except socket.timeout:
                    continue
                with self._lock:
                    self._conns.append(c)
        finally:
            with self._lock:
                for c in self._conns:
                    try:
                        c.close()
                    except OSError:
                        pass
            self._srv.close()

    def stop(self):
        self.events.unsubscribe(self._push)
        self._stop.set()
        self._thread.join(timeout=2)
