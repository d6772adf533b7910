"""External storage — the pkg/cloud ExternalStorage reduction; the port of
``cockroach_tpu.utils.external_storage``.

Reference: BACKUP/RESTORE/IMPORT/changefeed sinks address storage by URI
(s3://, gs://, azure-blob://, nodelocal://, userfile://, http://); each
scheme resolves to an ExternalStorage implementation with a common
read/write/list/delete surface (pkg/cloud/external_storage.go).

Reduction: the same scheme registry and surface over implementations a
build without network can host — ``nodelocal://`` (a per-process base
directory, the reference's node-local store) and ``file://`` (absolute
paths). Cloud schemes register as explicit stubs whose error says what is
missing, so a BACKUP TO 's3://…' fails with configuration guidance
rather than a parse error. Consumers that need a directory on local disk
(the engine checkpoint) use ``as_local_dir()``, available on any
local-backed implementation.
"""

from __future__ import annotations

import os
from urllib.parse import urlparse

# nodelocal:// resolves under this base (settable for tests/servers; the
# reference's equivalent is the store's "extern" dir)
_NODELOCAL_BASE = os.environ.get("COCKROACH_TPU_EXTERN_DIR", ".extern")


def set_nodelocal_base(path: str) -> None:
    global _NODELOCAL_BASE
    _NODELOCAL_BASE = path


def _check_under(base: str, path: str, shown) -> None:
    """Reject paths outside the storage root. commonpath, NOT a string
    prefix: '/d/.extern-evil' shares the prefix of '/d/.extern' but is a
    sibling, not a child."""
    b = os.path.abspath(base)
    p = os.path.abspath(path)
    if os.path.commonpath([b, p]) != b:
        raise ValueError(f"path escapes storage root: {shown!r}")


class ExternalStorage:
    """Common surface (pkg/cloud/external_storage.go reduction)."""

    def write_file(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def read_file(self, name: str) -> bytes:
        raise NotImplementedError

    def list(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def delete(self, name: str) -> None:
        raise NotImplementedError

    def as_local_dir(self) -> str:
        """Local directory behind this storage, for consumers that write
        directory trees directly (engine checkpoints). Remote
        implementations would stage through a temp dir instead."""
        raise NotImplementedError


class LocalStorage(ExternalStorage):
    def __init__(self, base: str):
        self.base = base

    def _path(self, name: str) -> str:
        p = os.path.normpath(os.path.join(self.base, name))
        _check_under(self.base, p, name)
        return p

    def write_file(self, name: str, data: bytes) -> None:
        p = self._path(name)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)

    def read_file(self, name: str) -> bytes:
        with open(self._path(name), "rb") as f:
            return f.read()

    def list(self, prefix: str = "") -> list[str]:
        out = []
        root = self.base
        for dirpath, _, files in os.walk(root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), root)
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def delete(self, name: str) -> None:
        os.unlink(self._path(name))

    def as_local_dir(self) -> str:
        os.makedirs(self.base, exist_ok=True)
        return self.base


class UnconfiguredStorage(ExternalStorage):
    """Cloud schemes the zero-egress build cannot reach: every operation
    fails with guidance (the reference fails similarly when credentials
    or implementations are absent)."""

    def __init__(self, scheme: str):
        self.scheme = scheme

    def _no(self):
        raise RuntimeError(
            f"{self.scheme}:// storage is not configured in this build "
            "(no cloud egress); use nodelocal:// or file://"
        )

    write_file = read_file = list = delete = as_local_dir = (
        lambda self, *a, **k: self._no()
    )


def from_uri(uri: str) -> tuple[ExternalStorage, str]:
    """URI -> (storage, path-within-storage). Plain paths (no scheme)
    stay plain local paths for compatibility."""
    u = urlparse(uri)
    if not u.scheme or len(u.scheme) == 1:  # '', or a windows drive letter
        return LocalStorage(os.path.dirname(uri) or "."), os.path.basename(
            uri)
    if u.scheme == "nodelocal":
        # nodelocal://self/<path> | nodelocal://1/<path>
        return (LocalStorage(_NODELOCAL_BASE), u.path.lstrip("/"))
    if u.scheme == "file":
        return LocalStorage(os.path.dirname(u.path) or "/"), \
            os.path.basename(u.path)
    if u.scheme in ("s3", "gs", "azure-blob", "http", "https", "userfile"):
        return UnconfiguredStorage(u.scheme), u.path.lstrip("/")
    raise ValueError(f"unknown storage scheme {u.scheme!r} in {uri!r}")


def resolve_dir_uri(uri: str) -> str:
    """URI -> a local directory path (for directory-tree consumers like
    the engine checkpoint). Raises for unconfigured cloud schemes."""
    storage, path = from_uri(uri)
    base = storage.as_local_dir()
    full = os.path.normpath(os.path.join(base, path))
    _check_under(base, full, uri)
    os.makedirs(os.path.dirname(full) or ".", exist_ok=True)
    return full
