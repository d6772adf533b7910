"""Gossip — the pkg/gossip reduction.

The port of ``cockroach_tpu.flow.gossip``.

Reference: gossip.go:234 runs an epidemic protocol over node connections:
each node keeps an infoStore of versioned, TTL'd infos (node addresses,
store descriptors, cluster settings) and periodically push-pulls deltas
with peers; higher-version infos win. Here the same infoStore + push-pull
exchange over the DCN socket framing (flow/dcn.py): one exchange round
sends everything newer than what the peer reported and merges the peer's
response — repeated rounds converge every store in the component to the
union of the freshest infos (verified across two processes)."""

from __future__ import annotations

import json
import socket
import threading
import time

from ..utils import locks, racesan, settings
from .dcn import _recv_msg, _send_msg


class Info:
    __slots__ = ("key", "value", "version", "origin")

    def __init__(self, key: str, value, version: int, origin: int):
        self.key = key
        self.value = value
        self.version = version
        self.origin = origin

    def to_wire(self) -> dict:
        return {"k": self.key, "v": self.value, "ver": self.version,
                "o": self.origin}

    @staticmethod
    def from_wire(d: dict) -> "Info":
        # coerce BEFORE anything merges: a peer sending a malformed info
        # (e.g. version as a string) must fail decode, not poison the
        # infoStore with values later comparisons choke on
        return Info(str(d["k"]), d["v"], int(d["ver"]), int(d["o"]))


class Gossip:
    """infoStore + push-pull exchange. add_info bumps the local version
    counter; merge keeps the higher (version, origin) per key.

    The store is BOUNDED (`max_infos`, gossip.go's infoStore limits
    role): when full, the lowest-version foreign info is evicted — a
    flapping peer republishing junk cannot grow memory without bound.
    `note_epoch` expires every info a fenced origin published: once a
    node's liveness epoch is bumped, state it gossiped under the old
    epoch is stale by definition (its leases are fenced, its address
    may be reused)."""

    def __init__(self, node_id: int, max_infos: int = 4096):
        self.node_id = int(node_id)
        self.max_infos = int(max_infos)
        self._infos: dict[str, Info] = {}
        self._node_epochs: dict[int, int] = {}  # highest KNOWN epoch
        self._clock = 0
        self._lock = locks.lock("gossip")
        self._srv: socket.socket | None = None
        self._stop = threading.Event()

    # -- info store ----------------------------------------------------------

    def add_info(self, key: str, value) -> None:
        with self._lock:
            racesan.note_write(self, "_infos")
            self._clock += 1
            self._infos[key] = Info(key, value, self._clock, self.node_id)
            self._enforce_bound()

    def note_epoch(self, node_id: int, epoch: int) -> None:
        """A node's liveness epoch was observed at `epoch`: drop every
        info that node originated under any earlier observation. The
        node itself keeps gossiping after it re-heartbeats — its NEW
        infos merge normally (higher versions win as usual)."""
        from ..utils import metric

        node_id = int(node_id)
        with self._lock:
            if self._node_epochs.get(node_id, 0) >= epoch:
                return
            self._node_epochs[node_id] = int(epoch)
            stale = [k for k, i in self._infos.items()
                     if i.origin == node_id]
            for k in stale:
                del self._infos[k]
            if stale:
                metric.GOSSIP_INFOS_EVICTED.inc(len(stale))

    def _enforce_bound(self) -> None:
        """Caller holds self._lock. Evict lowest-version FOREIGN infos
        first (our own infos are authoritative here and re-publishable
        only by us); fall back to lowest-version overall if the store is
        somehow all-local."""
        from ..utils import metric

        while len(self._infos) > self.max_infos:
            foreign = [i for i in self._infos.values()
                       if i.origin != self.node_id]
            pool = foreign if foreign else list(self._infos.values())
            victim = min(pool, key=lambda i: (i.version, i.origin))
            del self._infos[victim.key]
            metric.GOSSIP_INFOS_EVICTED.inc()

    def get_info(self, key: str):
        with self._lock:
            racesan.note_read(self, "_infos")
            info = self._infos.get(key)
            return None if info is None else info.value

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._infos)

    def _merge(self, infos: list[Info]) -> int:
        fresh = 0
        with self._lock:
            racesan.note_write(self, "_infos")
            for info in infos:
                cur = self._infos.get(info.key)
                if (cur is None
                        or (info.version, info.origin)
                        > (cur.version, cur.origin)):
                    self._infos[info.key] = info
                    self._clock = max(self._clock, info.version)
                    fresh += 1
            self._enforce_bound()
        return fresh

    def _snapshot(self) -> list[dict]:
        with self._lock:
            return [i.to_wire() for i in self._infos.values()]

    # -- push-pull exchange --------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """Answer exchange requests (the inbound half of gossip.Server)."""
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.2)

        def loop():
            while not self._stop.is_set():
                try:
                    conn, _ = self._srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    # close() raced the accept (fd already closed): the
                    # server is shutting down, not failing
                    return
                # the single serve thread reads the peer's delta before
                # answering: a peer that dials and stalls mid-exchange
                # must time out, not wedge gossip for the whole cluster
                conn.settimeout(settings.get("flow.dcn.io_timeout_s"))
                try:
                    # malformed or truncated exchanges must not kill the
                    # server loop — drop the connection and keep accepting
                    msg = _recv_msg(conn)
                    if msg is None:
                        continue
                    theirs = json.loads(msg.decode("utf-8",
                                                   errors="replace"))
                    self._merge([Info.from_wire(d) for d in theirs])
                    _send_msg(conn, json.dumps(
                        self._snapshot()).encode("utf-8"))
                except (OSError, ValueError, KeyError, TypeError):
                    pass
                finally:
                    conn.close()

        threading.Thread(target=loop, daemon=True).start()
        return self._srv.getsockname()

    def exchange(self, addr) -> int:
        """One push-pull round with a peer; returns infos learned."""
        from ..utils import faults

        # chaos site: a dropped broadcast round models a partitioned
        # gossip link (node-scoped so tests can isolate one node)
        faults.fire_scoped("gossip.broadcast", self.node_id)
        # bounds the connect AND persists as the per-read deadline: a
        # peer that accepts and then goes silent fails this round with
        # socket.timeout (caught by run_background's retry loop) instead
        # of freezing the node's only gossip thread forever
        sock = socket.create_connection(
            tuple(addr), timeout=settings.get("flow.dcn.io_timeout_s"))
        try:
            _send_msg(sock, json.dumps(self._snapshot()).encode("utf-8"))
            theirs = json.loads(_recv_msg(sock).decode("utf-8"))
            return self._merge([Info.from_wire(d) for d in theirs])
        finally:
            sock.close()

    def run_background(self, peers: list, interval_s: float = 0.5):
        """Periodic exchanges with static peers (the bootstrap resolver
        shape; adaptive peer selection arrives with the member list)."""
        def loop():
            while not self._stop.is_set():
                for p in peers:
                    try:
                        self.exchange(p)
                    except (OSError, ValueError, TypeError, KeyError):
                        # a bad peer must not kill the gossip thread; the
                        # next round retries
                        pass
                time.sleep(interval_s)

        threading.Thread(target=loop, daemon=True).start()

    def close(self):
        self._stop.set()
        if self._srv is not None:
            self._srv.close()
