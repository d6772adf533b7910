"""Runtime data-race sanitizer — the Eraser lockset algorithm over
control-plane shared state; the port of ``cockroach_tpu.utils.racesan``.

Per tracked field the sanitizer keeps a tiny state machine:

* **exclusive(owner)** — only one thread has touched the field so far.
  Single-threaded init and publish-before-spawn patterns never report.
* on the first access from a SECOND thread the field transfers to a
  shared state and its candidate lockset ``C`` is seeded from the locks
  that thread holds (``C := L``);
* every later access refines ``C ∩= L``.  The moment ``C`` goes empty on
  a write-involved access — a lockset-disjoint write/write or
  write-after-read-under-different-locks — :class:`DataRaceError` is
  raised at the access, naming both sides' threads and locksets.

The lockset is the per-thread held stack of ``utils/locks.py``'s named
locks, so "lock" here means a named control-plane lock. Product code
instruments a shared field with one line at each access::

    racesan.note_write(self, "_conns")   # under the publishing lock
    racesan.note_read(self, "_conns")

Both are a single settings check while ``debug.race_detector.enabled``
is off: no tracking state is allocated. Tests arm the detector and call
:func:`reset` between scenarios.
"""

from __future__ import annotations

import threading

from . import locks, settings

__all__ = ["DataRaceError", "note_read", "note_write", "reset", "armed"]


class DataRaceError(RuntimeError):
    """Two threads accessed a tracked field (at least one write) with no
    common lock ever held across the accesses."""


class _FieldState:
    __slots__ = ("mode", "owner", "written", "lockset",
                 "last_writer", "last_writer_locks")

    def __init__(self, owner: int):
        self.mode = "exclusive"     # exclusive | shared | shared_mod
        self.owner = owner
        self.written = False
        self.lockset: frozenset | None = None  # candidate set C
        self.last_writer: str | None = None
        self.last_writer_locks: frozenset = frozenset()


# keyed by (id(obj), field); the entry pins a strong ref to obj so the id
# cannot be recycled while armed. Bounded: tracking only allocates while
# the detector is on, and the chaos fixture reset()s between tests.
_mu = threading.Lock()  # leaf lock: never taken while calling out
_fields: dict[tuple[int, str], tuple[object, _FieldState]] = {}


def armed() -> bool:
    return bool(settings.get("debug.race_detector.enabled"))


def reset() -> None:
    """Drop all tracking state (test isolation)."""
    with _mu:
        _fields.clear()


def note_write(obj: object, field: str) -> None:
    """Record a write to ``obj.field`` by the current thread. Call at the
    assignment site, under whatever lock guards it."""
    if armed():
        _note(obj, field, True)


def note_read(obj: object, field: str) -> None:
    """Record a read of ``obj.field`` by the current thread."""
    if armed():
        _note(obj, field, False)


def _note(obj: object, field: str, is_write: bool) -> None:
    tid = threading.get_ident()
    held = frozenset(locks._held_stack())
    tname = threading.current_thread().name
    with _mu:
        key = (id(obj), field)
        entry = _fields.get(key)
        if entry is None:
            st = _FieldState(tid)
            _fields[key] = (obj, st)
        else:
            st = entry[1]
        if st.mode == "exclusive":
            if st.owner == tid:
                st.written = st.written or is_write
                if is_write:
                    st.last_writer, st.last_writer_locks = tname, held
                return
            # ownership transfer: second thread arrives. Seed C from ITS
            # lockset — the first thread's accesses are already history
            # (Eraser's refinement-starts-at-sharing rule, which is what
            # lets single-threaded init go unguarded without a report).
            st.mode = ("shared_mod" if (is_write or st.written)
                       else "shared")
            st.lockset = held
        else:
            if is_write:
                st.mode = "shared_mod"
            st.lockset = (held if st.lockset is None
                          else st.lockset & held)
        racy = st.mode == "shared_mod" and not st.lockset
        if is_write:
            prev = (st.last_writer, st.last_writer_locks)
            st.last_writer, st.last_writer_locks = tname, held
        else:
            prev = (st.last_writer, st.last_writer_locks)
        if not racy:
            return
        what = "write" if is_write else "read"
        other = (f"last write by thread {prev[0]!r} holding "
                 f"{sorted(prev[1]) or 'no locks'}" if prev[0]
                 else "an earlier unlocked access")
        raise DataRaceError(
            f"data race on {type(obj).__name__}.{field}: {what} by thread "
            f"{tname!r} holding {sorted(held) or 'no locks'} shares no "
            f"lock with {other} — no common lock ever guarded this field "
            "across threads"
        )
