"""Per-UE context and radio-bearer management + HSS user database.

(reference capability: ``LTE_fdd_enb_user.{h,cc}`` /
``LTE_fdd_enb_user_mgr.{h,cc}`` / ``LTE_fdd_enb_rb.{h,cc}`` — per-UE
context with C-RNTI, security context and radio bearers — and
``LTE_fdd_enb_hss.{h,cc}`` — the IMSI/K/OPc user file with the
``add_user``/``del_user``/``print_users`` ctrl commands.)

The port's own copy of ``lteax/stack/users.py`` (it imports nothing of the
JAX package); ``tests/test_torch_stack.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile


@dataclasses.dataclass
class RadioBearer:
    rb_id: int
    mode: str = "am"           # tm | um | am
    lcid: int = 1

    def make_rlc(self):
        """Instantiate this bearer's RLC entity pair (tx, rx) per mode;
        TM has no entity state (transparent pass-through) -> (None, None)."""
        if self.mode == "am":
            from lteax_torch.stack.rlc_am import AmTransmitter, AmReceiver
            return AmTransmitter(), AmReceiver()
        if self.mode == "um":
            from lteax_torch.stack.rlc_um import UmTransmitter, UmReceiver
            return UmTransmitter(), UmReceiver()
        return None, None


@dataclasses.dataclass
class SecurityCtx:
    ksi: int = 0
    k_asme: bytes = b""
    nas_count_ul: int = 0
    nas_count_dl: int = 0


@dataclasses.dataclass
class UserCtx:
    c_rnti: int
    imsi: str = ""
    state: str = "idle"        # idle | attaching | connected
    sec: SecurityCtx = dataclasses.field(default_factory=SecurityCtx)
    bearers: dict[int, RadioBearer] = dataclasses.field(default_factory=dict)

    def add_bearer(self, rb_id: int, mode: str = "am",
                   lcid: int | None = None) -> RadioBearer:
        rb = RadioBearer(rb_id=rb_id, mode=mode,
                         lcid=lcid if lcid is not None else rb_id)
        self.bearers[rb_id] = rb
        return rb


class UserManager:
    C_RNTI_START = 0x003D

    def __init__(self):
        self._by_rnti: dict[int, UserCtx] = {}
        self._by_imsi: dict[str, int] = {}
        self._next = self.C_RNTI_START

    C_RNTI_END = 0xFFF3

    def add_user(self, imsi: str = "") -> UserCtx:
        if len(self._by_rnti) >= self.C_RNTI_END - self.C_RNTI_START:
            raise RuntimeError("C-RNTI space exhausted")
        while self._next in self._by_rnti or self._next > self.C_RNTI_END:
            self._next = self._next + 1 if self._next < self.C_RNTI_END \
                else self.C_RNTI_START
        u = UserCtx(c_rnti=self._next, imsi=imsi)
        self._by_rnti[u.c_rnti] = u
        if imsi:
            self._by_imsi[imsi] = u.c_rnti
        self._next = self._next + 1 if self._next < self.C_RNTI_END \
            else self.C_RNTI_START
        return u

    def find(self, c_rnti: int) -> UserCtx | None:
        return self._by_rnti.get(c_rnti)

    def find_imsi(self, imsi: str) -> UserCtx | None:
        rnti = self._by_imsi.get(imsi)
        return self._by_rnti.get(rnti) if rnti is not None else None

    def release(self, c_rnti: int) -> bool:
        u = self._by_rnti.pop(c_rnti, None)
        if u is None:
            return False
        self._by_imsi.pop(u.imsi, None)
        return True

    def __len__(self):
        return len(self._by_rnti)


class Hss:
    """IMSI -> (K, OPc) database with atomic file persistence."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._users: dict[str, dict] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self._users = json.load(f)

    def _save(self):
        if not self.path:
            return
        d = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self._users, f)
        os.replace(tmp, self.path)

    def add_user(self, imsi: str, k_hex: str, opc_hex: str) -> None:
        self._users[imsi] = {"k": k_hex, "opc": opc_hex}
        self._save()

    def del_user(self, imsi: str) -> bool:
        if imsi in self._users:
            del self._users[imsi]
            self._save()
            return True
        return False

    def get_user(self, imsi: str) -> tuple[bytes, bytes] | None:
        u = self._users.get(imsi)
        if u is None:
            return None
        return bytes.fromhex(u["k"]), bytes.fromhex(u["opc"])

    def print_users(self) -> str:
        return "\n".join(sorted(self._users)) or "(none)"

    def ctrl_commands(self) -> dict:
        """Verbs for apps.ctrl.CtrlServer (reference command parity)."""
        return {
            "add_user": lambda a: (self.add_user(a[0], a[1], a[2]),
                                   f"added {a[0]}")[1],
            "del_user": lambda a: ("deleted" if self.del_user(a[0])
                                   else "unknown imsi"),
            "print_users": lambda a: self.print_users(),
        }
