"""Node lifecycle — the server.Server / node startup reduction; the port of
``cockroach_tpu.server.node``.

Reference: pkg/server/server.go assembles the engine, liveness heartbeats,
gossip, the jobs registry and the timeseries poller around one stopper;
pkg/server/node.go is the per-node identity. This Node composes the same
subsystems over one Engine/DB so they run as a system:

- liveness: a background heartbeat keeps this node's epoch-stamped record
  fresh (kv/liveness.py); the jobs registry fences stale claimants with it;
- jobs: Registry(liveness=...) adopts orphaned jobs of dead nodes on a
  ticker (jobs/adopt.go's claim-expired loop);
- tsdb: a metrics poller snapshots the default registry into the
  timeseries keyspace on a ticker (ts/db.go PollSource role);
- gossip: optional; serves an infostore endpoint, exchanges with peers,
  and bridges cluster settings both ways — a SET here publishes
  ``setting/<name>``, a fresher remote info applies locally;
- admission: the engine's IOGovernor feeds the shed ladder;
- leases, the Batch RPC endpoint, the range lifecycle over a DistSender,
  pgwire (with the warm menu, sql/warmmenu.warm_node) and the HTTP admin
  API (server/http.py).

``start``/``stop`` bound every thread (the stopper discipline). The node's
store is an ``Engine(key_width=64, val_width=128)`` on ``device``
(``"cuda"`` by default; without a card the constructor raises unless the
caller passes ``device="cpu"``). Beyond the reference, ``catalog=`` gives
the SQL server a catalog to serve (the reference starts an empty one) and
``menu=`` an explicit course for the warm menu.
"""

from __future__ import annotations

import os
import threading
import time

from ..device import resolve_device
from ..kv import DB, Clock
from ..kv.jobs import Registry, register_builtin_jobs
from ..kv.liveness import LeaseManager, NodeLiveness
from ..kv.tsdb import TimeSeriesDB
from ..storage.lsm import Engine
from ..utils import admission, log, metric, settings


class Node:
    def __init__(
        self,
        node_id: int = 1,
        db: DB | None = None,
        engine: Engine | None = None,
        heartbeat_interval_s: float = 0.2,
        ttl_ms: int = 1000,
        metrics_interval_s: float | None = 0.5,
        adopt_interval_s: float = 0.5,
        gossip_peers: list | None = None,
        lease_ranges: list[int] | None = None,
        device="cuda",
        catalog=None,
        menu=None,
    ):
        self.device = resolve_device(device)
        self.node_id = int(node_id)
        self.db = db if db is not None else DB(
            # tsdb keys are "\x01ts<metric>|<13-digit ms>" and metric names
            # run to about 30 bytes: the node store takes wide keys
            engine if engine is not None else Engine(
                key_width=64, val_width=128, device=self.device),
            Clock(),
        )
        if self.db.engine.device != self.device:
            raise ValueError(f"store on {self.db.engine.device}, node on "
                             f"{self.device}: pass the store's device")
        self.liveness = NodeLiveness(
            self.db, self.node_id,
            heartbeat_interval_ms=int(heartbeat_interval_s * 1000),
            ttl_ms=ttl_ms,
        )
        # epoch leases: the node competes for every range in lease_ranges;
        # a vacant or dead-holder lease is taken after fencing the
        # holder's liveness epoch
        self.leases = LeaseManager(self.liveness)
        self._lease_ranges = list(lease_ranges or [])
        self._advertised_leases: dict[int, tuple[int, int]] = {}
        self.jobs = Registry(self.db, node_id=self.node_id,
                             liveness=self.liveness)
        register_builtin_jobs(self.jobs)
        self.tsdb = TimeSeriesDB(self.db)
        self.gossip = None
        self._gossip_peers = list(gossip_peers or [])
        self._hb_interval = heartbeat_interval_s
        self._metrics_interval = metrics_interval_s
        self._adopt_interval = adopt_interval_s
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._settings_cb = None
        self._applying_remote = False
        self._catalog = catalog
        self.menu = menu
        # range lifecycle (kv/allocator.py): wired in start() when the DB
        # is DistSender-backed and kv.allocator.enabled
        self.ranger = None
        self._wired_sender = None
        self._lease_guard_local = threading.local()
        # the routing guard's liveness cache: this node's record from its
        # last heartbeat, and the ranges that passed the guard under it
        self._live = None
        self._guard_passed: dict[int, int] = {}
        self.disk = self.admin = self.kv_rpc = self.dialer = self.pg = None
        self._warmmenu_run = None

    # -- lifecycle -----------------------------------------------------------

    def start(self, gossip_port: int | None = 0,
              pg_port: int | None = None,
              http_port: int | None = None,
              kv_port: int | None = None) -> "Node":
        self._stop.clear()
        # own record exists before anything reads
        self._live = self.liveness.heartbeat()

        # disk health: a WAL-backed engine gets a monitor fed by its own
        # WAL appends plus a periodic probe (storage/disk.py)
        eng = self.db.engine
        if getattr(eng, "wal_path", None):
            from ..storage.disk import DiskMonitor

            self.disk = DiskMonitor(
                os.path.dirname(eng.wal_path) or ".").start()
            eng.disk_monitor = self.disk

        # pending upgrade migrations run before serving (the store's
        # persisted version catches up to the binary's)
        from ..kv.upgrade import run_upgrades

        for name in run_upgrades(self.db):
            log.info(log.OPS, "upgrade migration complete", name=name)

        # the serving engine's L0 health feeds the admission shed ladder
        if getattr(eng, "governor", None) is not None:
            admission.set_io_health_provider(eng.governor.l0_overload)

        self._spawn(self._heartbeat_loop, "liveness-heartbeat")
        self._spawn(self._metrics_loop, "tsdb-poller")
        self._spawn(self._adopt_loop, "jobs-adopt")

        if http_port is not None:
            from .http import AdminServer

            self.admin = AdminServer(self, port=http_port).serve_background()

        if kv_port is not None:
            from ..kv.rpc import BatchServer

            # the Internal.Batch endpoint: range-addressed mutation batches
            # pass the lease check, so a fenced node answers
            # EpochFencedError instead of writing under a lost epoch
            self.kv_rpc = BatchServer(self.db, port=kv_port,
                                      lease_check=self._lease_check)
        if self._lease_ranges:
            self._spawn(self._lease_loop, "lease-acquire")

        if pg_port is not None:
            from ..catalog import Catalog
            from .pgwire import PgServer

            # every pgwire connection gets its own Session over this
            # node's shared catalog and DB (conn-executor-per-session)
            self._sql_catalog = (self._catalog if self._catalog is not None
                                 else Catalog(self.device))
            self.pg = PgServer(catalog=self._sql_catalog, db=self.db,
                               port=pg_port,
                               device=self.device).serve_background()

        if gossip_port is not None and (self._gossip_peers
                                        or gossip_port >= 0):
            from ..flow.gossip import Gossip
            from ..kv.dialer import NodeDialer, advertise

            self.gossip = Gossip(self.node_id)
            self._gossip_addr = self.gossip.serve(port=gossip_port)
            if self._gossip_peers:
                self.gossip.run_background(self._gossip_peers,
                                           interval_s=0.1)
            self._settings_cb = self._publish_setting
            settings.on_change(self._settings_cb)
            self._spawn(self._settings_apply_loop, "gossip-settings")
            # advertise the KV endpoint and hand out a dialer: peers
            # resolve node ids through gossip, never addresses
            if self.kv_rpc is not None:
                advertise(self.gossip, self.node_id, self.kv_rpc.addr)
            self.dialer = NodeDialer(self.gossip)

        # range lifecycle: a DistSender-backed node runs the split, merge
        # and rebalance queues and carries the (holder, epoch) guard onto
        # every routed piece
        from ..kv.dist import DistSender

        sender = self.db.engine
        if isinstance(sender, DistSender):
            if sender.lease_check is None:
                sender.lease_check = self._dist_lease_check
                self._wired_sender = sender
            if settings.get("kv.allocator.enabled"):
                from ..kv.allocator import RangeLifecycle
                from ..kv.loadstats import RangeLoadStats

                if sender.load is None:
                    sender.load = RangeLoadStats()
                self.ranger = RangeLifecycle(
                    sender, load=sender.load, leases=self.leases,
                    gossip=self.gossip, node_id=self.node_id,
                    store_nodes={sid: self.node_id
                                 for sid in sender.stores},
                    # scans walk span_stats over every range: pace them
                    # well below the heartbeat cadence
                    interval_s=max(self._hb_interval * 5, 0.25),
                )
                self.ranger.start()
        if (getattr(self, "_sql_catalog", None) is not None
                and settings.get("sql.warmup.menu.enabled")):
            # the menu builds before the node reports readiness, bounded
            # by sql.warmup.menu.budget_s
            from ..sql import warmmenu

            warmmenu.warm_node(self)
        log.info(log.OPS, "node started", node=self.node_id)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._warmmenu_run is not None:
            # a budget-bound straggler stops at its next statement boundary
            self._warmmenu_run.stop_join()
            self._warmmenu_run = None
        admission.set_io_health_provider(None)
        if self.ranger is not None:
            self.ranger.stop()
            self.ranger = None
        if self._wired_sender is not None:
            self._wired_sender.lease_check = None
            self._wired_sender = None
        if self._settings_cb is not None:
            settings.remove_on_change(self._settings_cb)
            self._settings_cb = None
        # stop() may run on a node thread (the fenced heartbeat path):
        # joining yourself deadlocks, so skip the calling thread
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5)
        self._threads.clear()
        if self.gossip is not None:
            self.gossip.close()
            self.gossip = None
        for name in ("pg", "admin", "kv_rpc", "dialer"):
            srv = getattr(self, name)
            if srv is not None:
                srv.close()
                setattr(self, name, None)
        if self.disk is not None:
            self.disk.stop()
            self.disk = None
        log.info(log.OPS, "node stopped", node=self.node_id)

    # the stopper's public teardown name
    close = stop

    def _dist_lease_check(self, range_id: int) -> None:
        """DistSender routing guard: where this node holds the range's
        lease, verify the (holder, epoch) pair is still valid, so a fenced
        node fails every piece of a multi-range batch. Vacant or foreign
        leases pass (the server-side guard owns those).

        Most pieces are answered from the node's own liveness record as
        its last heartbeat wrote it (the reference's liveness cache):
        while that record is unexpired no peer can have bumped its epoch
        (``increment_epoch`` refuses a live record), and every lease write
        names its holder under that holder's epoch of the moment, so a
        range that passed under this epoch passes until the record lapses.
        The first piece of a range, and every piece once the record has
        lapsed or a heartbeat was fenced, reads the lease and liveness
        records (the reference reads both on every piece: ROADMAP Queue 3
        item 37). Those reads route through the same sender, so a
        thread-local skips the nested check; an intent on either record
        (a transfer or a heartbeat mid-commit, possibly waiting on the
        sender lock this request holds) is served under the current terms
        at once, not waited out: the epoch check re-asserts on the next
        request."""
        from ..kv.liveness import _LEASE_REC, _REC, EpochFencedError
        from ..kv.txn import TransactionRetryError
        from ..storage.lsm import WriteIntentError

        if getattr(self._lease_guard_local, "busy", False):
            return
        live = self._live
        if (live is not None and self._guard_passed.get(range_id) == live.epoch
                and live.live_at(self.db.clock.now())):
            return
        self._lease_guard_local.busy = True
        try:
            v = self.db.get(LeaseManager._key(range_id))
            if v is not None:
                holder, epoch, _ = _LEASE_REC.unpack(v)
                if holder == self.node_id:
                    rec = self.db.get(NodeLiveness._key(self.node_id))
                    now_epoch = None if rec is None else _REC.unpack(rec)[0]
                    if now_epoch != epoch:
                        raise EpochFencedError(
                            f"node {self.node_id} serving r{range_id} under "
                            f"epoch {epoch} but liveness is at {now_epoch}")
            if live is not None:
                self._guard_passed[range_id] = live.epoch
        except (WriteIntentError, TransactionRetryError):
            pass
        finally:
            self._lease_guard_local.busy = False

    def _spawn(self, fn, name: str) -> None:
        t = threading.Thread(target=fn, name=f"{name}-n{self.node_id}",
                             daemon=True)
        t.start()
        self._threads.append(t)

    # -- loops ---------------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        from ..kv.liveness import EpochFencedError
        from ..kv.txn import TransactionRetryError

        while not self._stop.wait(self._hb_interval):
            try:
                self._live = self.liveness.heartbeat()
            except EpochFencedError:
                self._live = None
                # declared dead by a peer: the whole node stops taking work
                # (a fenced node that keeps adopting jobs runs them beside
                # its fencer)
                log.warning(log.OPS, "heartbeat fenced; stopping node",
                            node=self.node_id)
                self._stop.set()
                return
            except TransactionRetryError:
                continue  # contended heartbeat key; the next tick retries
            except (ConnectionError, OSError):
                # a blackholed heartbeat: the record ages toward expiry
                # while the node keeps trying
                continue

    # -- leases ---------------------------------------------------------------

    def _lease_check(self, req: dict) -> None:
        """BatchServer guard for range-addressed mutation batches: raises
        EpochFencedError / NotLeaseHolderError when this node may not
        serve the range. Batches without a range address pass."""
        from ..kv.liveness import NotLeaseHolderError
        from ..storage.lsm import WriteIntentError

        rid = req.get("range")
        if rid is not None:
            try:
                self.leases.check(int(rid))
            except WriteIntentError as e:
                # the lease or liveness record is mid-commit: unresolved,
                # so do not serve; typed, so the router retries
                raise NotLeaseHolderError(
                    f"r{rid} lease state unresolved (record mid-commit); "
                    f"retry") from e

    def _lease_loop(self) -> None:
        from ..kv.liveness import NotLeaseHolderError, StillLiveError
        from ..kv.txn import TransactionRetryError
        from ..storage.lsm import WriteIntentError

        while not self._stop.wait(self._hb_interval):
            for rid in self._lease_ranges:
                try:
                    prev = self.leases.holder(rid)
                    rec = self.leases.acquire(rid)
                except NotLeaseHolderError:
                    continue  # a live peer holds it
                except (StillLiveError, TransactionRetryError):
                    continue  # lost a failover race; the next tick re-reads
                except WriteIntentError:
                    continue  # a peer's lease write mid-commit
                except (ConnectionError, OSError):
                    continue  # an injected transport fault
                # crlint: allow-broad-except(lease loop must survive; logged)
                except Exception as e:  # noqa: BLE001 - the loop survives; logged
                    log.warning(log.OPS, "lease acquire failed",
                                range=rid, error=str(e))
                    continue
                if (prev is not None and prev.node_id != self.node_id
                        and self.gossip is not None):
                    # the old holder was just fenced: its gossiped state
                    # is stale under the bumped epoch
                    self.gossip.note_epoch(prev.node_id, prev.epoch + 1)
                ad = (rec.node_id, rec.epoch)
                if (self._advertised_leases.get(rid) != ad
                        and self.gossip is not None):
                    self.gossip.add_info(f"lease/{rid}",
                                         f"{rec.node_id}:{rec.epoch}")
                    self._advertised_leases[rid] = ad

    def _metrics_loop(self) -> None:
        from ..kv import hlc

        last_prune = time.monotonic()
        while True:
            # the constructor's interval wins when given; otherwise the
            # live setting paces the scraper
            iv = (self._metrics_interval if self._metrics_interval is not None
                  else settings.get("ts.scrape_interval_seconds"))
            if self._stop.wait(iv):
                return
            try:
                # re-publish the pull-style gauges so each scrape records
                # live values even when nothing ran since the last tick
                from ..flow import memory as flowmem
                from ..kv import fanout
                from ..storage import blockcache

                flowmem.refresh_gauges()
                admission.refresh_gauges()
                blockcache.refresh_gauges()
                fanout.refresh_gauges()
                self.tsdb.record(metric.DEFAULT)
                retention = settings.get("ts.retention_seconds")
                # a retention trim scans the whole ts keyspace: about one
                # in ten ticks
                if retention and time.monotonic() - last_prune >= iv * 10:
                    wall, _ = hlc.unpack(self.db.clock.now())
                    self.tsdb.prune_all(wall - int(retention * 1e3))
                    last_prune = time.monotonic()
            # crlint: allow-broad-except(metric write must never kill the node; logged)
            except Exception as e:  # noqa: BLE001 - a metric write never kills the node; logged
                log.warning(log.OPS, "tsdb poll failed", error=str(e))

    def _adopt_loop(self) -> None:
        while not self._stop.wait(self._adopt_interval):
            try:
                for j in self.jobs.adopt_orphans():
                    log.info(log.OPS, "re-adopted orphaned job",
                             job=j.job_id, state=j.state)
            # crlint: allow-broad-except(adoption pass failure is logged, loop continues)
            except Exception as e:  # noqa: BLE001 - logged; the loop continues
                log.warning(log.OPS, "adoption pass failed", error=str(e))

    # -- gossip <-> settings bridge ------------------------------------------

    _SETTING_PREFIX = "setting/"

    def _publish_setting(self, name: str, value) -> None:
        if self.gossip is None or self._applying_remote:
            return
        self.gossip.add_info(self._SETTING_PREFIX + name, value)

    def _settings_apply_loop(self) -> None:
        applied: dict[str, object] = {}
        while not self._stop.wait(0.1):
            if self.gossip is None:
                return
            for key in self.gossip.keys():
                if not key.startswith(self._SETTING_PREFIX):
                    continue
                name = key[len(self._SETTING_PREFIX):]
                info = self.gossip.get_info(key)
                if info is None or applied.get(name) == info:
                    continue
                try:
                    self._applying_remote = True
                    settings.set(name, info)
                    applied[name] = info
                # crlint: allow-broad-except(bad gossiped value is logged and pinned to avoid a retry storm)
                except Exception as e:  # noqa: BLE001 - a bad value is logged and pinned
                    log.warning(log.OPS, "gossiped setting rejected",
                                setting=name, error=str(e))
                    applied[name] = info  # no retry storm on a bad value
                finally:
                    self._applying_remote = False

    def gossip_addr(self):
        return getattr(self, "_gossip_addr", None)
