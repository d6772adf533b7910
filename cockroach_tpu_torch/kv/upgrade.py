"""Cluster version + upgrade migrations — the pkg/clusterversion +
pkg/upgrade reduction.

The port of ``cockroach_tpu.kv.upgrade``.

Reference: every store persists the cluster version; on startup (and on
SET CLUSTER SETTING version = ...) the upgrade manager runs each
registered migration between the persisted version and the binary's
version, in order, idempotently, and only then bumps the persisted
version (pkg/upgrade/upgrademanager). Feature gates check
``clusterversion.Is Active`` before using new formats.

Reduction: versions are (major, minor) pairs persisted at a system key;
migrations register against the version that ACTIVATES them; ``run_
upgrades(db)`` applies pending ones transactionally (each migration runs,
then the version bumps — a crash between re-runs the migration, which
must therefore be idempotent, same contract as the reference). The
Node runs this at start.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .txn import DB

_VERSION_KEY = b"\x01ver"
_VER = struct.Struct("<ii")

# the version this binary ships (bump when a migration is added)
BINARY_VERSION = (4, 2)


@dataclass(frozen=True)
class Migration:
    version: tuple[int, int]  # runs when persisted version is below this
    name: str
    fn: object  # fn(db) -> None, idempotent


_MIGRATIONS: list[Migration] = []


def register_migration(version: tuple[int, int], name: str):
    """Decorator: register fn(db) to run when upgrading past `version`."""
    def deco(fn):
        _MIGRATIONS.append(Migration(tuple(version), name, fn))
        _MIGRATIONS.sort(key=lambda m: m.version)
        return fn
    return deco


def active_version(db: DB) -> tuple[int, int]:
    v = db.get(_VERSION_KEY)
    if v is None:
        return (0, 0)
    return _VER.unpack(v[:_VER.size])


def is_active(db: DB, version: tuple[int, int]) -> bool:
    """Feature gate: has the cluster upgraded past `version`?"""
    return active_version(db) >= tuple(version)


def run_upgrades(db: DB, to_version: tuple[int, int] = BINARY_VERSION,
                 migrations: list[Migration] | None = None) -> list[str]:
    """Run every registered migration in (active, to_version], bumping the
    persisted version after EACH (so a crash mid-sequence resumes at the
    failed migration, not the start). Returns the names that ran."""
    from ..utils import log

    ran: list[str] = []
    cur = active_version(db)
    if cur == (0, 0):
        # no version record. A FRESH store bootstraps straight at the
        # target (nothing to migrate); a LEGACY store (data written by a
        # pre-versioning binary) must run EVERY migration from (0,0) —
        # the two are distinguished by whether any data exists at all
        probe = db.scan(None, None, max_keys=1)
        if not probe:
            db.put(_VERSION_KEY, _VER.pack(*to_version))
            return ran
    for m in (migrations if migrations is not None else _MIGRATIONS):
        if cur < m.version <= tuple(to_version):
            log.info(log.OPS, "running upgrade migration", name=m.name,
                     version=f"{m.version[0]}.{m.version[1]}")
            m.fn(db)
            db.put(_VERSION_KEY, _VER.pack(*m.version))
            cur = m.version
            ran.append(m.name)
    if cur < tuple(to_version):
        db.put(_VERSION_KEY, _VER.pack(*to_version))
    return ran
