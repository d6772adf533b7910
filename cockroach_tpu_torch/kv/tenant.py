"""Multi-tenancy (reduced) — shared-KV tenants with keyspace isolation; the
port of ``cockroach_tpu.kv.tenant``.

Reference: pkg/multitenant + pkg/ccl/sqlproxyccl + kvclient/kvtenant run
SQL pods against a shared KV cluster, each tenant confined to its own
keyspace prefix and gated by a capability set (tenantcapabilities). This
reduction keeps the architectural invariants on the engine's one-byte
table-prefix keyspace (storage/rowcodec.py):

- every tenant owns a DISJOINT table-id range, so its keys occupy a
  disjoint span of the shared LSM by construction — no runtime check can
  leak cross-tenant rows because the catalog cannot even address them;
- tenant records live in the system keyspace (b"\\x01tnt"), created/
  altered only through the system tenant (tenant 1), mirroring how the
  reference gates tenant DDL on the system tenant;
- capabilities gate tenant-visible features at the Session dispatch
  boundary (can_create_table, can_backup, max_tables — the
  tenantcapabilities.CanUseNodelocalStorage/... role).

Scale bound (documented divergence): the one-byte table prefix caps the
keyspace at 253 table ids, so tenants get 16-id ranges past the system
tenant's 1..127 — enough for the test matrix, not production scale; the
reference's varint tenant prefixes lift that bound, not the design.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..storage.rowcodec import MAX_TABLE_ID
from .table import _SYSTEM_RANGE
from .txn import DB

_PREFIX = b"\x01tnt"

SYSTEM_TENANT_ID = 1
# utils/admission.py hardcodes this id (the utils layer must not import
# kv); keep the two pinned together
from ..utils.admission import SYSTEM_TENANT_ID as _ADM_SYSTEM_ID  # noqa: E402

assert _ADM_SYSTEM_ID == SYSTEM_TENANT_ID

_RANGE_WIDTH = 16
_FIRST_SECONDARY_LO = 128

DEFAULT_CAPS = {
    "can_create_table": True,
    "can_backup": False,
    "max_tables": _RANGE_WIDTH // 2,  # table + dictionary span per table
}


class TenantError(Exception):
    pass


class CapabilityError(TenantError):
    """A tenant attempted an operation its capability set denies."""


@dataclass
class TenantRecord:
    tenant_id: int
    name: str
    id_lo: int
    id_hi: int
    caps: dict = field(default_factory=dict)

    def to_bytes(self) -> bytes:
        return json.dumps({
            "tenant_id": self.tenant_id, "name": self.name,
            "id_lo": self.id_lo, "id_hi": self.id_hi, "caps": self.caps,
        }).encode()

    @staticmethod
    def from_bytes(b: bytes) -> "TenantRecord":
        d = json.loads(bytes(b).decode())
        return TenantRecord(d["tenant_id"], d["name"], d["id_lo"],
                            d["id_hi"], d["caps"])


def _key(tenant_id: int, chunk: int = 0) -> bytes:
    # records chunk across rows like table descriptors (kv/chunked.py):
    # the JSON outgrows small engine value widths
    return _PREFIX + b"%03d|%02d" % (tenant_id, chunk)


def _write_record(t, rec: "TenantRecord", val_width: int) -> None:
    from .chunked import chunk_blob

    step = max(16, val_width - 1)
    for ci, piece in enumerate(chunk_blob(rec.to_bytes(), step)):
        t.put(_key(rec.tenant_id, ci), piece)


def _decode_records(rows) -> list["TenantRecord"]:
    from .chunked import unchunk

    by_id: dict[bytes, list[tuple[bytes, bytes]]] = {}
    for k, v in rows:
        tid = k[len(_PREFIX):].split(b"|")[0]
        by_id.setdefault(tid, []).append((k, v))
    return [
        TenantRecord.from_bytes(unchunk([v for _, v in sorted(chunks)]))
        for _, chunks in sorted(by_id.items())
    ]


class TenantRegistry:
    """Tenant records in the shared KV store. All mutations run as
    transactions so concurrent CREATE TENANT calls serialize on the
    record keys (same discipline as jobs id allocation)."""

    def __init__(self, db: DB):
        self.db = db

    # -- reads -------------------------------------------------------------

    def list(self) -> list[TenantRecord]:
        from ..utils.errors import retry_past_intents

        rows = retry_past_intents(
            lambda: self.db.scan(_PREFIX, _PREFIX + b"\xff")
        )
        return _decode_records(rows)

    def get(self, name_or_id) -> TenantRecord:
        for rec in self.list():
            if rec.tenant_id == name_or_id or rec.name == name_or_id:
                return rec
        raise TenantError(f"tenant {name_or_id!r} does not exist")

    # -- system-tenant DDL ---------------------------------------------------

    def create(self, name: str, caps: dict | None = None) -> TenantRecord:
        """Allocate the next disjoint table-id range and persist the
        record; the whole read-allocate-write runs in one txn."""
        if not name or name == "system":
            raise TenantError("invalid tenant name")

        out: list[TenantRecord] = []

        def op(t):
            out.clear()
            existing = _decode_records(t.scan(_PREFIX, _PREFIX + b"\xff"))
            if any(r.name == name for r in existing):
                raise TenantError(f"tenant {name!r} already exists")
            next_id = max((r.tenant_id for r in existing),
                          default=SYSTEM_TENANT_ID) + 1
            lo = _FIRST_SECONDARY_LO + _RANGE_WIDTH * (next_id - 2)
            hi = lo + _RANGE_WIDTH - 1
            if hi > MAX_TABLE_ID:
                raise TenantError(
                    "tenant keyspace exhausted (one-byte table prefix; "
                    "see module docstring)"
                )
            rec = TenantRecord(next_id, name, lo, hi,
                               dict(DEFAULT_CAPS, **(caps or {})))
            _write_record(t, rec, self.db.engine.val_width)
            out.append(rec)

        self.db.txn(op)
        return out[0]

    def set_capability(self, name: str, cap: str, value) -> TenantRecord:
        out: list[TenantRecord] = []

        def op(t):
            out.clear()
            for rec in _decode_records(t.scan(_PREFIX, _PREFIX + b"\xff")):
                if rec.name == name:
                    rec.caps[cap] = value
                    _write_record(t, rec, self.db.engine.val_width)
                    out.append(rec)
                    return
            raise TenantError(f"tenant {name!r} does not exist")

        self.db.txn(op)
        return out[0]

    def drop(self, name: str) -> None:
        """Drop the record. Table data in the tenant's range stays until
        GC (the reference also decouples record drop from data GC)."""
        def op(t):
            rows = t.scan(_PREFIX, _PREFIX + b"\xff")
            for rec in _decode_records(rows):
                if rec.name == name:
                    if rec.tenant_id == SYSTEM_TENANT_ID:
                        raise TenantError("cannot drop the system tenant")
                    pref = _PREFIX + b"%03d|" % rec.tenant_id
                    for k, _ in rows:
                        if k.startswith(pref):
                            t.delete(k)
                    return
            raise TenantError(f"tenant {name!r} does not exist")

        self.db.txn(op)

    def bootstrap(self) -> TenantRecord:
        """Ensure the system tenant record exists (idempotent)."""
        def op(t):
            if t.get(_key(SYSTEM_TENANT_ID)) is None:
                rec = TenantRecord(
                    SYSTEM_TENANT_ID, "system", *_SYSTEM_RANGE,
                    {"can_create_table": True, "can_backup": True,
                     "max_tables": 63},
                )
                _write_record(t, rec, self.db.engine.val_width)

        self.db.txn(op)
        return self.get(SYSTEM_TENANT_ID)


def check_capability(rec: TenantRecord, cap: str) -> None:
    if not rec.caps.get(cap, False):
        raise CapabilityError(
            f"tenant {rec.name!r} lacks capability {cap!r}"
        )
