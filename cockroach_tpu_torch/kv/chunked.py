"""Chunked record persistence — blobs across fixed-width engine values;
the port of ``cockroach_tpu.kv.chunked``.

One shared discipline for every system record that can outgrow a single
engine value (table descriptors, job records, table statistics): the blob
is prefixed with an 8-hex-char length header and split into
value-width-sized chunks under consecutive chunk keys. The header makes
STALE TRAILING CHUNKS harmless: a shorter rewrite leaves the old tail in
place, and readers truncate to the declared length instead of choking on
extra bytes (the bug class this module exists to kill — a 13-column
descriptor shrunk by DROP COLUMN used to corrupt catalog bootstrap).
"""

from __future__ import annotations

_HEADER = 8  # ascii hex length prefix


def chunk_blob(blob: bytes, step: int) -> list[bytes]:
    """Split header+blob into <=step-sized chunks (at least one)."""
    assert step > _HEADER, f"chunk step {step} too small"
    b = b"%08x" % len(blob) + blob
    return [b[i:i + step] for i in range(0, len(b), step)] or [b]


def unchunk(values: list[bytes]) -> bytes:
    """Reassemble chunks (in key order) -> original blob, ignoring any
    stale tail bytes past the declared length.

    Legacy records (written before the header existed) reassemble as the
    raw concatenation: every caller stores JSON, whose first byte ('{')
    can never appear in the hex header, so the formats self-discriminate
    — a checkpoint from an older build stays restorable."""
    b = b"".join(values)
    head = b[:_HEADER]
    if len(head) == _HEADER and all(c in b"0123456789abcdef" for c in head):
        total = int(head, 16)
        return b[_HEADER:_HEADER + total]
    return b  # pre-header legacy record
