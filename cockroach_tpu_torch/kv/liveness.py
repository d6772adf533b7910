"""Node liveness + epoch leases — the kvserver/liveness analog; the port
of ``cockroach_tpu.kv.liveness``.

Reference: liveness.go:241 NodeLiveness heartbeats an epoch-stamped record
into the KV store; a record whose expiration passed marks the node dead,
and INCREMENTING ITS EPOCH (by another node) fences any leases the dead
node held — the failure-detection primitive leases and the allocator build
on. Here the same record/epoch/fencing state machine runs over the engine's
KV surface (records in a reserved system keyspace, in the engine on the
session's device): multiple NodeLiveness instances sharing one DB behave
like nodes sharing the liveness range.

LeaseManager adds the epoch-lease half (replica_range_lease.go reduced):
a range lease names (holder node, holder's liveness epoch); it is valid
exactly while the holder's liveness record still carries that epoch.
Failover = expire -> a peer bumps the epoch (the fencing write) -> the
peer writes itself in as holder. A resurrected holder fails the epoch
equality check and must re-acquire, never serve stale. Nothing in the
port routes through leases yet (the reference's kv/dist.py is not
ported); the manager is here whole, and tested.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .txn import DB

# system keyspace: table id 0's prefix byte (0x01) + a NUL-free tag — the
# engine's zero-padded fixed-width keys reject 0x00 bytes, so node ids
# encode as fixed-width decimal ASCII (order-preserving, NUL-free)
_PREFIX = b"\x01liv"
_REC = struct.Struct("<qqq")  # epoch, expiration_ts, node_id

_LEASE_PREFIX = b"\x01lse"
_LEASE_REC = struct.Struct("<qqq")  # node_id, epoch, range_id


class StillLiveError(Exception):
    """increment_epoch refused: the target's record has not expired."""


class EpochFencedError(Exception):
    """The node's epoch was incremented by a peer (it was declared dead):
    every lease it held under the old epoch is invalid and it must not
    heartbeat the old epoch back to life."""


class NotLeaseHolderError(Exception):
    """The addressed node does not hold the range's lease (kvpb's
    NotLeaseHolderError): `holder` carries the current holder's node id
    when known, so the client can reroute instead of guessing."""

    def __init__(self, msg: str, holder: int | None = None):
        super().__init__(msg)
        self.holder = holder


# fencing/routing errors cross the query error boundary unwrapped so
# callers can key on the type (colexecerror.ExpectedError discipline)
from ..utils.errors import register_passthrough as _rp  # noqa: E402

_rp(StillLiveError)
_rp(EpochFencedError)
_rp(NotLeaseHolderError)


@dataclass(frozen=True)
class LivenessRecord:
    node_id: int
    epoch: int
    expiration: int  # hlc timestamp

    def live_at(self, ts: int) -> bool:
        return ts < self.expiration


class NodeLiveness:
    """One node's view of the shared liveness records."""

    def __init__(self, db: DB, node_id: int,
                 heartbeat_interval_ms: int = 4500,
                 ttl_ms: int = 9000):
        self.db = db
        self.node_id = int(node_id)
        self.ttl_ms = ttl_ms
        self.heartbeat_interval_ms = heartbeat_interval_ms
        self._my_epoch: int | None = None  # epoch this node believes it owns

    @staticmethod
    def _key(node_id: int) -> bytes:
        return _PREFIX + b"%05d" % node_id

    def _read(self, node_id: int, reader=None) -> LivenessRecord | None:
        """reader: pass the open Txn inside txn closures so the read lands
        in the txn's read spans (commit-time refresh validates it) and a
        concurrent writer's intent converts to TransactionRetryError rather
        than surfacing WriteIntentError out of db.get.

        Non-transactional status reads (is_live from the admin API or the
        jobs adoption loop) instead retry briefly past a concurrent
        heartbeat's intent: a status probe must never fail just because a
        heartbeat is mid-commit (the reference's liveness cache serves such
        reads from gossiped state for the same reason)."""
        if reader is not None:
            v = reader.get(self._key(node_id))
        else:
            from ..utils.errors import retry_past_intents

            v = retry_past_intents(lambda: self.db.get(self._key(node_id)))
        if v is None:
            return None
        epoch, exp, nid = _REC.unpack(v)
        return LivenessRecord(nid, epoch, exp)

    # -- the node's own record ---------------------------------------------

    def heartbeat(self) -> LivenessRecord:
        """Extend this node's expiration under the epoch it believes it
        owns. Raises EpochFencedError if a peer incremented the epoch (the
        node was declared dead; its old leases are invalid)."""
        from ..utils import faults

        # chaos site: a blackholed heartbeat models the node losing its
        # liveness range (network partition / stalled disk). Fires the
        # node-scoped variant too so a test can kill ONE node's
        # heartbeats while its peers keep renewing.
        faults.fire_scoped("liveness.heartbeat", self.node_id)

        def op(t):
            cur = self._read(self.node_id, t)
            now = self.db.clock.now()
            from . import hlc

            wall, _ = hlc.unpack(now)
            exp = hlc.pack(wall + self.ttl_ms, 0)
            if cur is None:
                rec = LivenessRecord(self.node_id, 1, exp)
            elif (self._my_epoch is not None
                    and cur.epoch != self._my_epoch):
                raise EpochFencedError(
                    f"node {self.node_id}: epoch {self._my_epoch} fenced "
                    f"(record at {cur.epoch})"
                )
            else:
                rec = LivenessRecord(self.node_id, cur.epoch, exp)
            t.put(self._key(self.node_id),
                  _REC.pack(rec.epoch, rec.expiration, rec.node_id))
            return rec

        rec = self.db.txn(op)
        self._my_epoch = rec.epoch
        return rec

    # -- other nodes --------------------------------------------------------

    def is_live(self, node_id: int) -> bool:
        rec = self._read(node_id)
        return rec is not None and rec.live_at(self.db.clock.now())

    def increment_epoch(self, node_id: int) -> LivenessRecord:
        """Declare a non-live node dead by bumping its epoch — the fencing
        write that invalidates its epoch-based leases. Refuses while the
        record is still live (liveness.go IncrementEpoch contract)."""
        from ..utils import faults

        # chaos site, scoped by the node DOING the bump (the fencer):
        # models IncrementEpoch's CPut losing a race / failing transport
        faults.fire_scoped("liveness.epoch_bump", self.node_id)

        def op(t):
            cur = self._read(node_id, t)
            if cur is None:
                raise ValueError(f"no liveness record for node {node_id}")
            if cur.live_at(self.db.clock.now()):
                raise StillLiveError(
                    f"node {node_id} is still live; cannot increment epoch"
                )
            rec = LivenessRecord(node_id, cur.epoch + 1, cur.expiration)
            t.put(self._key(node_id),
                  _REC.pack(rec.epoch, rec.expiration, rec.node_id))
            return rec

        return self.db.txn(op)

    def livenesses(self) -> list[LivenessRecord]:
        from ..utils.errors import retry_past_intents

        # a peer's heartbeat may be mid-commit; status reads wait it out
        rows = retry_past_intents(
            lambda: self.db.scan(_PREFIX, _PREFIX + b"\xff"))
        out = []
        for _, v in rows:
            epoch, exp, nid = _REC.unpack(v)
            out.append(LivenessRecord(nid, epoch, exp))
        return out


@dataclass(frozen=True)
class LeaseRecord:
    range_id: int
    node_id: int
    epoch: int  # the holder's liveness epoch when the lease was written


class LeaseManager:
    """Epoch-based range leases over the liveness state machine
    (replica_range_lease.go reduced to the epoch-lease case).

    Invariant: a lease (holder, epoch) is valid exactly while the
    holder's liveness record still carries `epoch`. Nobody ever checks
    wall-clock expiration on the LEASE — fencing the liveness epoch is
    the single source of truth, so clock skew between nodes can't let
    two leaseholders coexist."""

    def __init__(self, liveness: NodeLiveness):
        self.liveness = liveness
        self.db = liveness.db
        self.node_id = liveness.node_id

    @staticmethod
    def _key(range_id: int) -> bytes:
        return _LEASE_PREFIX + b"%05d" % range_id

    def holder(self, range_id: int) -> LeaseRecord | None:
        from ..utils.errors import retry_past_intents

        v = retry_past_intents(lambda: self.db.get(self._key(range_id)))
        if v is None:
            return None
        nid, epoch, rid = _LEASE_REC.unpack(v)
        return LeaseRecord(rid, nid, epoch)

    def acquire(self, range_id: int) -> LeaseRecord:
        """Take (or renew) the range's lease for this node.

        - vacant lease: write ourselves in under our current epoch;
        - we already hold it: renew (rewrite under our current epoch);
        - a LIVE peer holds it: NotLeaseHolderError (reroute, don't
          steal);
        - a dead/fenced peer holds it: bump its liveness epoch first —
          the fencing write, so a resurrection can't serve under the
          old lease — then write ourselves in (kv_lease_failovers
          counts it)."""
        from ..utils import metric

        if self.liveness._my_epoch is None:
            self.liveness.heartbeat()  # allocates/learns our epoch
        my_epoch = self.liveness._my_epoch
        cur = self.holder(range_id)
        if cur is not None and cur.node_id != self.node_id:
            rec = self.liveness._read(cur.node_id)
            if (rec is not None and rec.epoch == cur.epoch
                    and rec.live_at(self.db.clock.now())):
                raise NotLeaseHolderError(
                    f"r{range_id} lease held by live node {cur.node_id}",
                    holder=cur.node_id)
            if rec is not None and rec.epoch == cur.epoch:
                # expired but not yet fenced: the epoch bump IS the
                # fencing write (StillLiveError surfaces if the holder
                # heartbeated between our check and the bump — callers
                # treat that as "lost the failover race")
                self.liveness.increment_epoch(cur.node_id)
            metric.LEASE_FAILOVERS.inc()

        def op(t):
            # re-validate under the txn so a racing acquirer's write
            # invalidates our read spans and retries/loses cleanly
            v = t.get(self._key(range_id))
            if v is not None:
                nid, epoch, _ = _LEASE_REC.unpack(v)
                if nid != self.node_id:
                    rec = self.liveness._read(nid, t)
                    if (rec is not None and rec.epoch == epoch
                            and rec.live_at(self.db.clock.now())):
                        raise NotLeaseHolderError(
                            f"r{range_id} lease held by live node {nid}",
                            holder=nid)
            t.put(self._key(range_id),
                  _LEASE_REC.pack(self.node_id, my_epoch, range_id))
            return LeaseRecord(range_id, self.node_id, my_epoch)

        return self.db.txn(op)

    def carry(self, parent_id: int, child_id: int) -> LeaseRecord | None:
        """Copy the parent range's (holder, epoch) onto a freshly split
        child — the reference's split trigger derives the RHS lease from
        the LHS so the new range is immediately servable by the same
        holder instead of starting a lease race. No-op when the parent's
        lease is vacant or the child already has one."""
        cur = self.holder(parent_id)
        if cur is None:
            return None

        def op(t):
            if t.get(self._key(child_id)) is not None:
                return None  # raced with an acquire; keep theirs
            t.put(self._key(child_id),
                  _LEASE_REC.pack(cur.node_id, cur.epoch, child_id))
            return LeaseRecord(child_id, cur.node_id, cur.epoch)

        return self.db.txn(op)

    def transfer(self, range_id: int, to_node: int) -> LeaseRecord:
        """Cooperative lease transfer (the AdminTransferLease reduction):
        stamp the target as holder under the TARGET's current liveness
        epoch. Only the current holder (or anyone, for a vacant lease)
        may transfer; the target must be live — a lease named under a
        dead node's epoch would be born fenced."""
        target = self.liveness._read(to_node)
        if target is None or not target.live_at(self.db.clock.now()):
            raise ValueError(f"lease transfer target node {to_node} not live")
        cur = self.holder(range_id)
        if (cur is not None and cur.node_id != self.node_id
                and to_node != self.node_id):
            raise NotLeaseHolderError(
                f"r{range_id}: node {self.node_id} cannot transfer a lease "
                f"held by node {cur.node_id}", holder=cur.node_id)

        def op(t):
            t.put(self._key(range_id),
                  _LEASE_REC.pack(to_node, target.epoch, range_id))
            return LeaseRecord(range_id, to_node, target.epoch)

        return self.db.txn(op)

    def release(self, range_id: int) -> None:
        """Drop the lease record (merge cleanup: the absorbed range id
        stops existing, so its lease must not linger and confuse a later
        id reuse)."""
        self.db.delete(self._key(range_id))

    def check(self, range_id: int) -> None:
        """Server-side serve guard: raises unless THIS node holds the
        lease under its CURRENT liveness epoch. A fenced node (epoch
        bumped while it was dark) fails the equality check no matter
        what its local state claims — the resurrect-after-fence case."""
        cur = self.holder(range_id)
        if cur is None or cur.node_id != self.node_id:
            raise NotLeaseHolderError(
                f"r{range_id} not leased to node {self.node_id}",
                holder=None if cur is None else cur.node_id)
        rec = self.liveness._read(self.node_id)
        if rec is None or rec.epoch != cur.epoch:
            raise EpochFencedError(
                f"node {self.node_id} serving r{range_id} under epoch "
                f"{cur.epoch} but liveness is at "
                f"{None if rec is None else rec.epoch}")
