"""``leaf_span``: a span that exists only while an operation is already
being traced. The storage slice starts no trace of its own, so its leaf
spans record nothing; the call sites stay where the reference has them."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def leaf_span(name: str, **tags):
    del name, tags
    yield None
