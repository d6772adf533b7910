"""Changefeeds — the changefeedccl reduction (CDC over MVCC history); the
port of ``cockroach_tpu.kv.changefeed``.

A changefeed is a job whose processors tail rangefeeds, encode changed
rows, push them to a sink and checkpoint a RESOLVED timestamp frontier
into the job record, so a restart resumes without loss or duplication.
Here the same loop runs over the engine's retained MVCC versions:

- the engine's history IS the feed source: ``_scan(lo, hi)`` lists the
  committed versions in (lo, hi] of a span plus the unresolved intents
  that hold the resolved frontier back (the catch-up scan shape,
  kvserver/rangefeed/catchup_scan.go);
- events encode as JSON lines {key, value|null, ts} (the wire envelope);
- the feed runs as a JOB: each poll emits events then checkpoints
  ``resolved``, so a crash and re-adoption resume from the frontier,
  exactly once per version;
- ``RangefeedServer`` pushes events over length-prefixed frames
  (flow/dcn.py), demuxed through the bounded fan-out plane of
  :mod:`.fanout`.

The scan runs where the engine's merged view lives (the card, for an
engine on ``"cuda"``): the span bounds, the version and intent selection
and the row compaction are device work, under ``flow/dispatch.exec_lock``
(then the engine mutex, the query path's order). Only the selected rows'
key, value, length, tombstone and timestamp cross to the host, packed in
one buffer at a capacity learned per engine: one device-to-host copy per
poll, a second only when the selection outgrew the capacity
(``scan_stats`` counts both). The capacity follows the last selection of
the same span (the next power of two over it); a scan from timestamp 0
(a whole-history replay) leaves it as it was, so later polls do not
copy a table's size.
"""

from __future__ import annotations

import base64
import json
import threading
import weakref

import numpy as np
import torch

from ..device import resolve_device
from ..flow import dispatch
from ..storage import keys as K
from ..utils import locks
from .jobs import Job, Registry
from .txn import DB

_MIN_CAP = 1024
# engine -> {span: the packed buffer's row capacity}, a power of two over
# the span's last selection
_caps: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_stats_mu = threading.Lock()
_stats = {"scans": 0, "rows": 0, "d2h_bytes": 0, "copies": 0}


def scan_stats() -> dict:
    """Process totals of ``_scan``: scans (one per engine: a cluster
    scans store by store), rows returned, device-to-host
    bytes and copies (one per scan unless a selection outgrew the learned
    capacity)."""
    with _stats_mu:
        return dict(_stats)


def check_device(db: DB, device) -> None:
    """An entry point's ``device`` (resolved: ``"cuda"`` needs a card)
    must be where the database's engine lives."""
    dev = resolve_device(device)
    if db.engine.device != dev:
        raise ValueError(f"engine on {db.engine.device}, entry point on "
                         f"{dev}: pass the engine's device")


def _as_bytes(t: torch.Tensor, width: int) -> torch.Tensor:
    """[n] fixed-width integers -> [n, width] uint8 (little-endian)."""
    return t.contiguous().view(torch.uint8).reshape(-1, width)


# crlint: allow-mem-accounting(one feed frame: at most cap + 1 packed rows of one poll's scan, bounded by the poll's row cap)
def _pack(view, pick: torch.Tensor, cap: int) -> torch.Tensor:
    """On the view's device: the first min(n, cap) rows where `pick`
    (view order), packed as uint8 rows key | value | vlen (4) | ts (8) |
    tomb | intent, under a header row whose first 8 bytes hold n."""
    dev = pick.device
    n_all = pick.shape[0]
    pos = torch.cumsum(pick.to(torch.int64), 0) - 1
    dest = torch.where(pick & (pos < cap), pos, cap)
    src = torch.full((cap + 1,), n_all - 1, dtype=torch.int64, device=dev)
    src.scatter_(0, dest, torch.arange(n_all, dtype=torch.int64,
                                       device=dev))
    src = src[:cap]
    rows = torch.cat([
        view.key[src], view.value[src],
        _as_bytes(view.vlen[src].to(torch.int32), 4),
        _as_bytes(view.ts[src].to(torch.int64), 8),
        view.tomb[src].to(torch.uint8)[:, None],
        (view.txn[src] != 0).to(torch.uint8)[:, None]], dim=1)
    header = torch.zeros((1, rows.shape[1]), dtype=torch.uint8, device=dev)
    header[0, :8] = _as_bytes(pos[-1:] + 1, 8)[0]
    return torch.cat([header, rows])


def _scan(db: DB, lo_ts: int, hi_ts: int,
          start: bytes | None = None,
          end: bytes | None = None,
          ) -> tuple[list[tuple[int, bytes, bytes | None]],
                     list[tuple[int, bytes]]]:
    """Committed versions with lo_ts < ts <= hi_ts in [start, end) as
    (ts, key, value|None) tuples ordered by (ts, key) — value None is a
    tombstone — plus the span's UNRESOLVED intents as (ts, key). This is
    the raw demux feed for the fan-out hub; :func:`changes_between` folds
    the intent list into the resolved frontier (kvserver/closedts): the
    frontier must not advance past an unresolved intent, or its eventual
    commit would fall behind an already-emitted resolved checkpoint and
    the event would be skipped forever.

    Over a cluster (``kv/dist.DistSender``) the scan runs store by store,
    as ``DistSender.scan_batch`` does: a value longer than ``val_width``
    sits in the value heap of the store that holds its version, and its
    slot holds an offset into that heap, which the stores' merged view
    cannot tell apart. The views are taken under the sender mutex, so a
    range move never shows its rows twice or not at all."""
    eng = db.engine
    stores = getattr(eng, "stores", None)
    with dispatch.exec_lock():
        # the snapshot is taken under the engine mutex (the merged view
        # consults and refills the overlay cache); the block it returns
        # is immutable, so the selection below runs without the mutex
        with eng.mu:
            if stores is None:
                views = [(eng, eng._merged_view())]
            else:
                views = []
                for s in stores.values():
                    with s.engine.mu:
                        views.append((s.engine, s.engine._merged_view()))
        picked = [(e, _select(e, v, lo_ts, hi_ts, start, end))
                  for e, v in views]
    versions: list[tuple[int, bytes, bytes | None]] = []
    intents: list[tuple[int, bytes]] = []
    for e, (host, n) in picked:
        if n:
            v, i = _decode(e, host[1:1 + n])
            versions.extend(v)
            intents.extend(i)
    if len(picked) > 1:
        versions.sort(key=lambda x: (x[0], x[1]))
    return versions, intents


def _select(eng, view, lo_ts: int, hi_ts: int, start, end):
    """(packed host rows, n): the span's versions in (lo_ts, hi_ts] and
    its intents from one engine's merged view, one copy to the host (two
    when the selection outgrew the capacity learned for the span)."""
    if view is None or view.capacity == 0:
        return None, 0
    kw = eng.key_width
    in_span = view.mask
    if start is not None or end is not None:
        words = K.key_words(view.key)
        in_span = in_span & K.words_in_range(
            words,
            K.words_tensor(K.encode_bound(start, kw), eng.device),
            K.words_tensor(K.encode_bound(end, kw), eng.device))
    intent = view.txn != 0
    pick = in_span & (intent | ((view.ts > int(lo_ts))
                                & (view.ts <= int(hi_ts))))
    caps = _caps.setdefault(eng, {})
    cap = caps.get((start, end), _MIN_CAP)
    copies = 0
    while True:
        host = _pack(view, pick, cap).cpu().numpy()
        copies += 1
        n = int(host[0, :8].view("<i8")[0])
        if n <= cap:
            break
        while cap < n:
            cap *= 2
    if lo_ts > 0:
        # a replay of the whole history (a view's prime, an oracle's
        # scan from 0) is a one-off: it does not size later polls
        cap = _MIN_CAP
        while cap < n:
            cap *= 2
        caps[(start, end)] = cap
    with _stats_mu:
        _stats["scans"] += 1
        _stats["rows"] += n
        _stats["d2h_bytes"] += int(host.nbytes)
        _stats["copies"] += copies
    return host, n


def _decode(eng, rows: np.ndarray):
    """Packed rows of one engine -> (versions ordered by (ts, key),
    intents); a value past ``val_width`` resolves from that engine's
    heap."""
    kw, vw = eng.key_width, eng.val_width
    keys = rows[:, :kw]
    o = kw + vw
    vlen = np.ascontiguousarray(rows[:, o:o + 4]).view("<i4")[:, 0]
    ts = np.ascontiguousarray(rows[:, o + 4:o + 12]).view("<i8")[:, 0]
    tomb = rows[:, o + 12].astype(bool)
    is_intent = rows[:, o + 13].astype(bool)
    iidx = np.nonzero(is_intent)[0]
    intents = [(int(ts[i]), k) for i, k in
               zip(iidx, K.decode_keys(keys[iidx]))]
    vidx = np.nonzero(~is_intent)[0]
    if len(vidx) == 0:
        return [], intents
    # (ts, key) order: the key's big-endian words compare as its bytes
    words = np.ascontiguousarray(keys[vidx]).view(">u8")
    vidx = vidx[np.lexsort(tuple(words[:, j] for j in
                                 range(words.shape[1] - 1, -1, -1))
                           + (ts[vidx],))]
    vkeys = K.decode_keys(keys[vidx])
    vals = np.ascontiguousarray(rows[vidx, kw:o])
    raw = vals.tobytes()  # row j's slot is raw[j * vw:(j + 1) * vw]
    out: list[tuple[int, bytes, bytes | None]] = []
    for j, (k, ln, t, dead) in enumerate(zip(
            vkeys, vlen[vidx].tolist(), ts[vidx].tolist(),
            tomb[vidx].tolist())):
        if dead:
            v = None
        elif ln <= vw:
            v = raw[j * vw:j * vw + ln]
        else:  # the slot holds an offset into the value heap
            with eng.mu:
                v = eng._resolve_value(vals[j], ln)
        out.append((t, k, v))
    return out, intents


def encode_event(ts: int, key: bytes, value: bytes | None,
                 raw: bool = False) -> dict:
    """The wire envelope for one committed version. raw=True gives the
    byte-exact base64 encoding (physical replication must reproduce
    keys/values verbatim, not a lossy utf-8 view)."""
    if raw:
        return {
            "k64": base64.b64encode(key).decode("ascii"),
            "v64": (None if value is None
                    else base64.b64encode(value).decode("ascii")),
            "ts": int(ts),
        }
    return {
        "key": key.decode("utf-8", "replace"),
        "value": (None if value is None
                  else value.decode("utf-8", "replace")),
        "ts": int(ts),
    }


def changes_between(db: DB, lo_ts: int, hi_ts: int,
                    start: bytes | None = None,
                    end: bytes | None = None,
                    raw: bool = False) -> tuple[list[dict], int]:
    """Committed versions with lo_ts < ts <= RESOLVED in [start, end),
    ordered by (ts, key), plus the RESOLVED frontier itself — the catch-up
    scan with the closed-timestamp discipline. Tombstones emit value None.
    Returns (events, resolved)."""
    versions, intents = _scan(db, lo_ts, hi_ts, start, end)
    # the resolved frontier holds below the oldest unresolved intent
    resolved = int(hi_ts)
    for its, _ikey in intents:
        resolved = min(resolved, int(its) - 1)
    events = [encode_event(t, k, v, raw)
              for t, k, v in versions if t <= resolved]
    return events, resolved


class FileSink:
    """JSON-lines sink (the cloud-storage sink reduction)."""

    def __init__(self, path: str):
        self.path = path

    def emit(self, events: list[dict]) -> None:
        with open(self.path, "a") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")


def register_changefeed_job(registry: Registry, polls: int = 1) -> None:
    """Changefeed as a jobs.Resumer: each poll emits (resolved, now] events
    to the sink then checkpoints the new resolved frontier."""

    def resume(reg: Registry, job: Job):
        from ..utils import faults

        sink = FileSink(job.payload["sink"])
        start = job.payload.get("start")
        end = job.payload.get("end")
        s = start.encode() if isinstance(start, str) else start
        e = end.encode() if isinstance(end, str) else end
        for _ in range(job.payload.get("polls", polls)):
            resolved = job.progress.get("resolved", 0)
            now = reg.db.clock.now()
            events, new_resolved = changes_between(
                reg.db, resolved, now, s, e)
            if events:
                sink.emit(events)
            # the frontier never regresses: a txn that began before the
            # last checkpoint may lay intents below it, but re-emitting
            # (old_resolved, new_resolved] would duplicate events
            job.progress["resolved"] = max(resolved, new_resolved)
            # a lost checkpoint write fails the job with events already
            # emitted; re-adoption resumes from the stale frontier and
            # re-emits (the sink dedups by (ts, key)), never skips
            faults.fire("changefeed.frontier.checkpoint")
            reg.checkpoint(job)
        return {"resolved": job.progress["resolved"]}

    registry.register("changefeed", resume)


class RangefeedServer:
    """Push rangefeed events over length-prefixed frames — the
    MuxRangeFeed reduction (kvpb api.proto:3700): a subscriber names a
    span and a start timestamp; the server streams JSON event frames as
    new versions commit, interleaved with resolved-timestamp checkpoints.

    Connections are demuxed through ONE :class:`~.fanout.FanoutHub` poll
    loop: each subscriber gets a budgeted buffer charged to the node's
    changefeed staging account, slow consumers walk the backpressure
    ladder, dead sockets are heartbeat-reaped within the send deadline,
    and an evicted client receives a typed ``{"error": "slow_consumer",
    "frontier": N}`` frame naming its exact reconnect point. ``device``
    must be where ``db``'s engine lives (``"cuda"`` needs a card)."""

    def __init__(self, db: DB, poll_interval_s: float = 0.05,
                 port: int = 0, device="cuda"):
        import socket

        from .fanout import FanoutHub

        check_device(db, device)
        self.db = db
        self.poll_interval_s = poll_interval_s
        # explicit port so a restarted source rebinds the SAME address
        self._srv = socket.create_server(("127.0.0.1", port))
        self._srv.settimeout(0.2)
        self.addr = self._srv.getsockname()
        self.hub = FanoutHub(db, poll_interval_s=poll_interval_s,
                             name=f"{self.addr[0]}:{self.addr[1]}",
                             device=db.engine.device)
        self._stop = threading.Event()
        # accepted connections, so close() severs them
        self._conns: set = set()
        self._conns_lock = locks.lock("kv.changefeed.conns")
        self._accept_thread = threading.Thread(target=self._serve,
                                               daemon=True)
        self._accept_thread.start()

    def _serve(self):
        import socket

        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # server socket closed
            with self._conns_lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._handshake, args=(conn,),
                             daemon=True).start()

    def _handshake(self, conn):
        """Per-connection handshake off the accept loop: a slow, broken or
        malicious client can neither stall new subscriptions nor kill the
        server thread."""
        from ..flow.dcn import _recv_msg

        try:
            conn.settimeout(10.0)
            msg = _recv_msg(conn)
            if msg is None:
                raise ConnectionError("empty handshake")
            req = json.loads(msg.decode("utf-8"))
            conn.settimeout(None)
        except (OSError, ValueError, ConnectionError):
            conn.close()
            self._discard(conn)
            return
        self._register(conn, req)

    def _register(self, conn, req):
        """Hand the connection to the fan-out hub."""
        from ..flow.dcn import _send_msg

        start = req.get("start")
        end = req.get("end")
        s = start.encode() if isinstance(start, str) else start
        e = end.encode() if isinstance(end, str) else end
        sub = self.hub.add_subscriber(
            conn, start=s, end=e, since=int(req.get("since", 0)),
            raw=bool(req.get("raw", False)),
            on_close=lambda: self._discard(conn))
        if sub is None:
            # bounded subscriber tree: refuse the newcomer with a typed
            # frame rather than degrade every existing registration
            try:
                _send_msg(conn, json.dumps(
                    {"error": "subscriber_limit"}).encode("utf-8"))
            except OSError:
                pass  # client already gone
            conn.close()
            self._discard(conn)

    def _discard(self, conn):
        with self._conns_lock:
            self._conns.discard(conn)

    def close(self):
        import socket

        self._stop.set()
        self._srv.close()
        # join the accept loop: a restart on the same port would
        # EADDRINUSE while a thread sits in accept()'s poll window
        if self._accept_thread is not threading.current_thread():
            self._accept_thread.join(timeout=5)
        # the hub severs registered subscribers and joins their senders
        self.hub.close()
        # handshake-phase stragglers never reached the hub
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()


def subscribe_rangefeed(addr, start=None, end=None, since: int = 0,
                        raw: bool = False):
    """Dial a RangefeedServer; returns (socket, iterator of frames).
    Frames are events ({key, value, ts} — or byte-exact {k64, v64, ts}
    with raw=True), checkpoints ({resolved}), or a terminal typed error
    ({error, frontier} — e.g. a slow-consumer eviction naming the exact
    ``since`` to reconnect with)."""
    import socket

    from ..flow.dcn import _recv_msg, _send_msg
    from ..utils import faults, settings

    # a failed (re)subscription: the restart path consumers retry through
    faults.fire("kv.rangefeed.subscribe")
    # bounds the connect and persists as the per-frame read deadline: a
    # server silent past it reads as end-of-feed, and the consumer
    # re-subscribes from its last checkpoint
    sock = socket.create_connection(
        tuple(addr), timeout=settings.get("flow.dcn.io_timeout_s"))
    _send_msg(sock, json.dumps({
        "start": start.decode() if isinstance(start, bytes) else start,
        "end": end.decode() if isinstance(end, bytes) else end,
        "since": since,
        "raw": raw,
    }).encode("utf-8"))

    def frames():
        while True:
            try:
                msg = _recv_msg(sock)
            except (ConnectionError, OSError):
                return  # server closed the stream: end of feed
            if msg is None:
                return
            try:
                yield json.loads(msg.decode("utf-8"))
            except ValueError:
                # a torn frame (the send deadline fired mid-write): the
                # stream is dead; resume from the last checkpoint
                return

    return sock, frames()
