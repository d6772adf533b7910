"""Changefeed fan-out bench — the subscriber-tree scaling oracle; the port
of ``cockroach_tpu.bench.fanout``.

One :class:`~cockroach_tpu.kv.fanout.FanoutHub` demuxes a live write
stream to ~1k subscribers with a deliberately mixed consumer population:

- **fast** (the bulk): drained promptly through one selector loop —
  these measure sustained delivery throughput and end-to-end lag
  (the writer embeds its wall-clock time in every value);
- **slow** (a handful): tiny socket buffers, never read — these must
  walk the backpressure ladder to a typed eviction WITHOUT stalling
  the emit path or wedging their peers;
- **flapping** (a handful): dropped mid-stream, then re-subscribed
  from their last resolved checkpoint — exactly-once after dedup.

The oracle (BENCH ``fanout.fanout_oracle_ok``) asserts the plane
survived being popular: every sampled fast consumer and every
reconnected flapper observed exactly the ``changes_between`` history
(no loss, no duplication after (ts, key) dedup), and the changefeed
staging account drained to zero after close (no leaked buffer bytes).

The engine, and with it the hub's poll scan, lives on ``device`` (the
card unless the caller passes ``"cpu"``).
"""

from __future__ import annotations

import json
import selectors
import socket
import struct
import threading
import time

_LEN = struct.Struct("<I")  # flow/dcn framing: little-endian u32 prefix


class _Consumer:
    """Client half of one subscription: incremental frame parser plus
    per-consumer delivery/frontier accounting (appends are GIL-atomic;
    the drain loop is the only writer)."""

    def __init__(self, sock: socket.socket, keep_events: bool):
        self.sock = sock
        self.buf = bytearray()
        self.resolved = 0
        self.delivered = 0
        self.error: dict | None = None
        self.events: dict | None = {} if keep_events else None

    def feed(self, data: bytes, lags: list, t_recv: float) -> None:
        self.buf.extend(data)
        buf, off = self.buf, 0
        try:
            while True:
                if len(buf) - off < _LEN.size:
                    return
                n = _LEN.unpack_from(buf, off)[0]
                if len(buf) - off < _LEN.size + n:
                    return
                payload = bytes(buf[off + _LEN.size:off + _LEN.size + n])
                off += _LEN.size + n
                self._frame(json.loads(payload.decode("utf-8")), lags,
                            t_recv)
        finally:
            # the parsed frames leave the buffer in one move, not one
            # move per frame
            del buf[:off]

    def _frame(self, frame: dict, lags: list, t_recv: float) -> None:
        if "resolved" in frame:
            self.resolved = max(self.resolved, int(frame["resolved"]))
        elif "error" in frame:
            self.error = frame
        else:
            self.delivered += 1
            val = frame.get("value")
            if self.events is not None:
                self.events[(int(frame["ts"]), frame["key"])] = val
            if val:
                try:
                    lags.append(t_recv - float(val))
                except ValueError:
                    pass  # pre-bench row without an embedded clock


def _drain_loop(sel: selectors.DefaultSelector, stop: threading.Event,
                lags: list) -> None:
    """ONE thread drains every fast/flapping consumer (epoll under the
    hood): the bench's client side must not need a thread per socket to
    keep up, or 1k subscribers would measure the harness, not the hub."""
    while not stop.is_set():
        for key, _mask in sel.select(timeout=0.2):
            cons: _Consumer = key.data
            try:
                data = cons.sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                data = b""
            if not data:
                try:
                    sel.unregister(cons.sock)
                except (KeyError, ValueError):
                    pass
                continue
            cons.feed(data, lags, time.time())


def _subscribe(hub, *, since: int = 0, sndbuf: int | None = None,
               keep_events: bool = False) -> tuple[_Consumer, object]:
    """One registration: a socketpair whose server half joins the tree
    and whose client half becomes a :class:`_Consumer`."""
    srv, cli = socket.socketpair()
    if sndbuf is not None:
        # a deliberately slow consumer: shrink both kernel buffers so
        # the sender wedges after a few frames instead of after the
        # default ~200KB of invisible kernel slack
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf)
        cli.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, sndbuf)
    sub = hub.add_subscriber(srv, since=since)
    if sub is None:  # tree at max_subscribers: bounded refusal
        srv.close()
        cli.close()
        return None, None
    cli.setblocking(False)
    return _Consumer(cli, keep_events), sub


def run_fanout(subscribers: int = 1000, duration_s: float = 10.0,
               n_keys: int = 32, txns: int = 30, puts_per_txn: int = 8,
               slow: int = 20, flappers: int = 20, device="cuda") -> dict:
    """Run the fan-out bench; returns the reference's ``detail["fanout"]``
    keys plus the changefeed scans' device-to-host figures and the
    staging account after close. See the module docstring for the
    population and the oracle."""
    from ..flow import memory as flowmem
    from ..kv.changefeed import changes_between, scan_stats
    from ..kv.fanout import EVICTED, FanoutHub
    from ..kv.txn import DB
    from ..storage.lsm import Engine
    from ..utils import metric, settings

    # val_width must hold the 17-byte "%.6f" wall-clock payload: the
    # engine's value lanes are fixed-width and silently NUL out writes
    # that don't fit the default 16
    db = DB(Engine(key_width=16, val_width=64, device=device))
    saved = {k: settings.get(k) for k in (
        "changefeed.fanout.send_deadline_s",
        "changefeed.fanout.heartbeat_s",
    )}
    # bench-scale liveness: a wedged consumer should be detected in ~2s
    # of wall time, not the production 5s default — the run is short
    settings.set("changefeed.fanout.send_deadline_s", 1.5)
    settings.set("changefeed.fanout.heartbeat_s", 0.25)
    evict0 = metric.CHANGEFEED_EVICTIONS.value
    sheds0 = metric.CHANGEFEED_SHEDS.value
    coal0 = metric.CHANGEFEED_EVENTS_COALESCED.value
    mon = flowmem.staging_monitor("changefeed")

    # poll slower than one cold overlay rebuild at this run count, or the
    # poller serializes the writer to one commit per rebuild (each commit
    # rewrites the engine's run set under the store mutex)
    hub = FanoutHub(db, poll_interval_s=0.5, name="bench", device=device)
    scans0 = scan_stats()
    sel = selectors.DefaultSelector()
    lags: list[float] = []
    fast: list[_Consumer] = []
    fast_subs: list = []
    flap: list[tuple[_Consumer, object]] = []
    slow_socks: list[socket.socket] = []
    n_fast = max(0, subscribers - slow - flappers)
    oracle_sample = 3  # full event maps only for a sample: O(events) each
    try:
        for i in range(n_fast):
            cons, sub = _subscribe(hub, keep_events=(i < oracle_sample))
            if cons is None:
                break
            fast.append(cons)
            fast_subs.append(sub)
            sel.register(cons.sock, selectors.EVENT_READ, cons)
        for _ in range(flappers):
            cons, sub = _subscribe(hub, keep_events=True)
            if cons is None:
                break
            flap.append((cons, sub))
            sel.register(cons.sock, selectors.EVENT_READ, cons)
        for _ in range(slow):
            cons, _sub = _subscribe(hub, sndbuf=4096)
            if cons is None:
                break
            slow_socks.append(cons.sock)  # held open, never drained

        stop = threading.Event()
        drainer = threading.Thread(target=_drain_loop,
                                   args=(sel, stop, lags),
                                   name="fanout-bench-drain", daemon=True)
        drainer.start()

        # -- write stream: several puts per txn (a statement batch), the
        # wall clock embedded in every value for end-to-end lag
        t0 = time.time()
        gap = (duration_s * 0.5) / max(txns, 1)
        seq = 0
        for t in range(txns):
            base = seq

            def w(txn, base=base):
                for j in range(puts_per_txn):
                    k = b"fk%03d" % ((base + j) % n_keys)
                    txn.put(k, b"%.6f" % time.time())
            db.txn(w)
            seq += puts_per_txn
            if t == txns // 2 and flap:
                # mid-stream drop: sever every flapper's client half; the
                # sender's next write fails and the hub evicts it
                for cons, _sub in flap:
                    try:
                        sel.unregister(cons.sock)
                    except (KeyError, ValueError):
                        pass
                    cons.sock.close()
            time.sleep(gap)
        hi = db.clock.now()

        # -- reconnect-from-frontier: each flapper re-dials with
        # since=<last checkpoint it saw>; dedup by (ts, key) must land it
        # on exactly the full history
        flap2: list[_Consumer] = []
        flap2_subs: list = []
        for cons, _sub in flap:
            re_cons, re_sub = _subscribe(hub, since=cons.resolved,
                                         keep_events=True)
            if re_cons is None:
                continue
            re_cons.events.update(cons.events)  # pre-drop deliveries
            flap2.append(re_cons)
            flap2_subs.append(re_sub)
            sel.register(re_cons.sock, selectors.EVENT_READ, re_cons)

        # -- convergence: every drained consumer's frontier reaches hi,
        # but for those the hub evicted, which never will
        watch = list(zip(fast + flap2, fast_subs + flap2_subs))
        deadline = time.time() + max(30.0, duration_s * 3)
        while time.time() < deadline:
            if all(c.resolved >= hi or sub.state == EVICTED
                   for c, sub in watch):
                break
            time.sleep(0.1)
        elapsed = time.time() - t0

        oracle, _res = changes_between(db, 0, hi)
        truth = {(int(e["ts"]), e["key"]): e["value"] for e in oracle}
        sustained = sum(1 for c in fast if c.resolved >= hi
                        and c.error is None)
        sampled = [(f"fast{i}", c)
                   for i, c in enumerate(fast[:oracle_sample])]
        sampled += [(f"flapper{i}", c) for i, c in enumerate(flap2)]
        oracle_ok = bool(sampled) and all(c.events == truth
                                          for _, c in sampled)
        # what a failed oracle saw: each sampled stream that differs, with
        # the eviction reason its error frame gave, if any
        misses = [{"consumer": who,
                   "error": None if c.error is None
                   else c.error.get("reason"),
                   "missing": len(truth.keys() - c.events.keys()),
                   "extra": len(c.events.keys() - truth.keys()),
                   "resolved": c.resolved >= hi}
                  for who, c in sampled if c.events != truth]
        # fast and reconnected consumers the hub evicted, by the reason it
        # recorded (its goodbye frame is best-effort and often lost)
        readers_evicted: dict[str, int] = {}
        for sub in fast_subs + flap2_subs:
            if sub.evict_error is not None:
                why = sub.evict_error.reason
                readers_evicted[why] = readers_evicted.get(why, 0) + 1
        delivered = sum(c.delivered for c in fast) + \
            sum(c.delivered for c in flap2)
        lag_sorted = sorted(lags)

        def pct(p: float) -> float:
            if not lag_sorted:
                return 0.0
            return lag_sorted[min(len(lag_sorted) - 1,
                                  int(p * (len(lag_sorted) - 1)))]

        peak = mon.high_water
        stop.set()
        drainer.join(timeout=5)
    finally:
        stop.set()
        hub.close()
        for s in slow_socks:
            s.close()
        for cons in fast:
            cons.sock.close()
        sel.close()
        for k, v in saved.items():
            settings.set(k, v)
    # the leak half of the oracle: close() must return every buffered
    # byte to the staging account
    staged_after = int(mon.used)
    oracle_ok = oracle_ok and staged_after == 0
    scans = {k: v - scans0[k] for k, v in scan_stats().items()}
    return {
        "subscribers": n_fast + len(flap) + len(slow_socks),
        "subscribers_sustained": sustained,
        "events_delivered": delivered,
        "events_delivered_per_sec": delivered / max(elapsed, 1e-9),
        "p50_lag_ms": pct(0.50) * 1e3,
        "p99_lag_ms": pct(0.99) * 1e3,
        "evictions": metric.CHANGEFEED_EVICTIONS.value - evict0,
        "sheds": metric.CHANGEFEED_SHEDS.value - sheds0,
        "coalesced": metric.CHANGEFEED_EVENTS_COALESCED.value - coal0,
        "peak_fanout_bytes": int(peak),
        "staging_bytes_after_close": staged_after,
        "scans": scans["scans"],
        "d2h_bytes_per_scan": scans["d2h_bytes"] / max(1, scans["scans"]),
        "copies_per_scan": scans["copies"] / max(1, scans["scans"]),
        "fanout_oracle_ok": bool(oracle_ok),
        "readers_evicted": readers_evicted,
        "oracle_misses": misses,
    }
