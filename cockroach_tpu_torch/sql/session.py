"""SQL session — DDL/DML execution over the KV layer (the conn-executor
analog, reduced to statement dispatch).

Reference shape: pkg/sql/conn_executor.go:2323 runs statements through the
planner; INSERT/UPDATE/DELETE encode rows and write through kv.Txn
(pkg/sql/insert.go, kv/txn.go), DDL creates descriptors. Here:

- CREATE TABLE registers a KVTable (storage/rowcodec row encoding, engine-
  backed, MVCC reads) in the catalog;
- INSERT VALUES / INSERT ... SELECT encode rows and put them inside ONE
  kv transaction (atomic: every row or none, write intents + commit);
- UPDATE/DELETE plan their WHERE through the same binder/engine as SELECT
  (a columnar scan computes the affected rows), then write the new
  versions / tombstones transactionally;
- SELECT returns columns through the standard bind/execute path.

- ALTER TABLE ADD/DROP COLUMN runs as a schema_change job
  (sql/schemachange.py); BACKUP TO runs as a backup job and RESTORE FROM
  swaps the engine in from the checkpoint (kv/jobs.py,
  utils/external_storage.py); CREATE/DROP/SHOW/ALTER TENANT and
  ``Session(tenant=...)`` run over kv/tenant.py.

Divergences (documented): single-node descriptors (table ids allocated
locally), and writes materialize the affected rows on the host before
re-encoding (no vectorized write path yet — the reference's colenc).

The port of ``cockroach_tpu.sql.session``: the catalog and the default
engine live on ``device`` (``"cuda"`` by default; without a card that
raises unless the caller passes ``device="cpu"``), and RESTORE opens the
checkpoint there. The one statement whose module the port has not got,
``crdb_internal.hot_ranges`` (kv/loadstats.py), raises ``BindError``
naming it (``UnportedError``). CREATE / DROP / REFRESH MATERIALIZED VIEW
go to sql/matview.py, a statement that names a view refreshes it first,
and a SELECT matching a view's shape and literals is served from it, as
in the reference. The slow-query log leaves a diagnostics bundle
(sql/diagnostics.py) as the reference's does.

Additions over the reference: ``execute`` answers EXPLAIN statements
(``sql.explain``'s forms, EXPLAIN ANALYZE (DEBUG) included) as one
``info`` column of text lines, so they answer over pgwire; and a SELECT
inside a transaction and the affected-row scan of an UPDATE or DELETE
(its WHERE and SET literals as parameters) run through the plan cache,
where the reference builds a fresh tree each time: on the card, a fresh
tree captures its graphs anew.
"""

from __future__ import annotations

import numpy as np

from ..catalog import Catalog
from ..coldata import types as T
from ..device import resolve_device
from ..kv import DB, Clock
from ..kv.table import KVTable, create_kv_table, reading_as
from ..kv.txn import TransactionRetryError
from ..storage.lsm import WriteIntentError
from ..storage import rowcodec
from ..storage.lsm import Engine
from . import parser as P
from .binder import BindError, Binder, ExprLowerer
from .rel import Rel


_TYPE_MAP = {
    "int": T.INT64, "integer": T.INT64, "bigint": T.INT64,
    "int8": T.INT64, "int4": T.INT32, "smallint": T.INT16,
    "float": T.FLOAT64, "double": T.FLOAT64, "real": T.FLOAT64,
    "float8": T.FLOAT64, "date": T.DATE, "timestamp": T.TIMESTAMP,
    "interval": T.INTERVAL, "bool": T.BOOL, "boolean": T.BOOL,
}


class NotALiteral(BindError):
    """The expression is not a constant (it references columns)."""


def _col_type(c: P.ColumnDef) -> T.SQLType:
    tn = c.type_name
    if tn in ("decimal", "numeric"):
        return T.DECIMAL(c.precision or 19,
                         c.scale if c.scale is not None else 2)
    if tn in ("string", "text", "varchar", "char"):
        return T.STRING
    t = _TYPE_MAP.get(tn)
    if t is None:
        raise BindError(f"unknown column type {tn!r}")
    return t


class Session:
    """One SQL session over one KV store. execute() returns:
    - SELECT: dict[str, np.ndarray] of result columns
    - INSERT/UPDATE/DELETE: {"rows_affected": n}
    - CREATE TABLE: {"created": name}
    """

    def __init__(self, catalog: Catalog | None = None, db: DB | None = None,
                 val_width: int = 128, key_width: int = 24,
                 bootstrap: bool = True, tenant: str | None = None,
                 device="cuda"):
        """bootstrap=False skips the catalog rediscovery scan — for servers
        (pgwire) that bootstrap the shared catalog ONCE and hand every
        connection's session the prebuilt one (re-running the descriptor
        scan per connection would replace live KVTable objects under
        concurrently executing sessions).

        tenant: run this session AS the named tenant over the shared KV
        store (kv/tenant.py) — catalog discovery and table creation are
        confined to the tenant's table-id range, and capability checks
        gate CREATE TABLE / BACKUP. None = the unscoped session
        (system-tenant powers, no restrictions).

        device: where the catalog and the default engine live; a catalog
        or DB passed in must live there too."""
        dev = resolve_device(device)
        self.catalog = catalog if catalog is not None else Catalog(dev)
        if self.catalog.device != dev:
            raise ValueError(
                f"catalog on {self.catalog.device}, session on {dev}: "
                "pass the catalog's device")
        # key_width must fit the WIDEST key family the session can write:
        # secondary-index entries are 21 bytes (kv/index.ENTRY_BYTES),
        # so the default is 24 (next multiple of 8), not the 16 a bare
        # primary-key session would need
        self.db = db if db is not None else DB(
            Engine(key_width=key_width, val_width=val_width,
                   memtable_size=4096, device=self.catalog.device),
            Clock(),
        )
        if self.db.engine.device != dev:
            raise ValueError(
                f"engine on {self.db.engine.device}, session on {dev}: "
                "a session runs on one device")
        self.tenant = None
        if tenant is not None:
            from ..kv.tenant import TenantRegistry

            reg = TenantRegistry(self.db)
            reg.bootstrap()
            self.tenant = reg.get(tenant)
            # admission capabilities bind here: a tenant carrying
            # admission_rate / admission_burst / admission_weight caps
            # gets its token bucket / fair-share weight configured past
            # the cluster defaults (tenant rate-limiter shape)
            caps = self.tenant.caps
            if any(k in caps for k in ("admission_rate", "admission_burst",
                                       "admission_weight")):
                from ..utils import admission as _adm

                _adm.sql_queue().configure_tenant(
                    self.tenant.tenant_id,
                    rate=caps.get("admission_rate"),
                    burst=caps.get("admission_burst"),
                    weight=caps.get("admission_weight"))
        if db is not None and bootstrap:
            # opening over an existing store: rediscover persisted tables
            # from their descriptors (the catalog bootstrap path), plus any
            # persisted ANALYZE statistics (system.table_statistics role)
            from ..kv.table import load_catalog_from_engine

            load_catalog_from_engine(
                self.catalog, self.db,
                id_range=(None if self.tenant is None
                          else (self.tenant.id_lo, self.tenant.id_hi)),
            )
            from . import stats as stats_mod

            for tbl in self.catalog.tables.values():
                if isinstance(tbl, KVTable):
                    st = stats_mod.load_kv_stats(self.db, tbl.table_id)
                    if st is not None:
                        tbl.set_stats(st)
        # explicit-transaction state machine: NoTxn (_txn None) / Open /
        # Aborted (_txn_aborted — only ROLLBACK/COMMIT leave it)
        self._txn = None
        self._txn_aborted = False
        # observability plumbing: the live-session registry entry, plus
        # the handles crdb_internal builders reach through the catalog
        from . import activity

        self._session_id = activity.register_session()
        self._active_qid = None
        self._last_fp = None
        self.catalog._crdb_db = self.db
        # this session's node in the memory-monitor tree: statements open
        # query monitors under it, so the session's used/peak aggregate
        # every statement's operator accounts (mon.BytesMonitor session
        # tier)
        from ..flow import memory as flowmem

        self._mem_mon = flowmem.session_monitor(
            f"session-{self._session_id}")

    def close(self) -> None:
        """Drop this session from the live registry (idempotent; a session
        that is never closed falls off the registry's bounded end). Joins
        the background plan-warmup thread first: a warmup racing teardown
        must stop at its next statement boundary, not execute against a
        closed store."""
        from . import activity, plancache

        plancache.stop_warmup(self)
        activity.deregister_session(self._session_id)
        self._mem_mon.close()

    def _set_phase(self, phase: str) -> None:
        if self._active_qid is not None:
            from . import activity

            activity.set_phase(self._active_qid, phase)

    # -- dispatch ------------------------------------------------------------

    def execute(self, text: str):
        handled = self._maybe_txn_stmt(text)
        if handled is not None:
            return handled
        if self._txn_aborted:
            raise BindError(
                "current transaction is aborted, commands ignored until "
                "end of transaction block (issue ROLLBACK)"
            )
        import time as _time

        from . import activity, sqlstats
        from ..flow import memory as flowmem
        from ..utils import admission, tracing

        t0 = _time.perf_counter()
        self._active_qid = activity.begin_query(self._session_id, text)
        self._last_fp = None
        err = False
        sp = None
        qmon = None
        try:
            # admission first (queue-wait is NOT query memory or trace
            # time), then the statement's query monitor under this
            # session's tier, then the root span of the statement's trace:
            # everything below — parse/bind, plan-cache lookup, flow pull,
            # KV batches, WAL appends — nests under them via contextvars.
            # The slot request carries this session's tenant, the
            # statement's lane (analytical sheds first under overload) and
            # the statement deadline: queue-wait counts against
            # statement_timeout, so a full queue is a fast typed 53300
            # instead of a silent stall
            with admission.sql_slot(
                    admission.classify_statement(text),
                    tenant_id=(None if self.tenant is None
                               else self.tenant.tenant_id),
                    deadline=self._statement_deadline()), \
                    flowmem.query_scope(self._mem_mon) as qmon, \
                    tracing.span("sql.execute",
                                 stmt=text.strip()[:120]) as sp:
                out = self._dispatch(text)
        except BaseException:
            # ANY failure inside an explicit block aborts it (postgres /
            # CRDB: subsequent statements are rejected until ROLLBACK)
            err = True
            if self._txn is not None:
                self._txn_aborted = True
            raise
        finally:
            activity.end_query(self._active_qid)
            self._active_qid = None
            elapsed = _time.perf_counter() - t0
            # peak/spills survive the monitor's close (read them off the
            # closed query monitor — the scope exited above)
            mem_peak = getattr(qmon, "high_water", 0)
            mem_spills = getattr(qmon, "spills", 0)
            if err:
                sqlstats.DEFAULT.record(text, elapsed, 0, error=True,
                                        fp=self._last_fp,
                                        mem_bytes=mem_peak,
                                        spills=mem_spills)
                self._maybe_slow_query(text, elapsed, sp, error=True)
        nrows = 0
        if isinstance(out, dict) and out:
            if "rows_affected" in out:  # DML verbs report affected rows
                nrows = int(out["rows_affected"])
            else:
                first = next(iter(out.values()))
                if hasattr(first, "__len__") and not isinstance(first, str):
                    nrows = len(first)
        sqlstats.DEFAULT.record(text, elapsed, nrows, fp=self._last_fp,
                                mem_bytes=mem_peak, spills=mem_spills)
        self._maybe_slow_query(text, elapsed, sp)
        return out

    def _maybe_slow_query(self, text: str, elapsed_s: float, span,
                          error: bool = False) -> None:
        """The slow-query log (sql.log.slow_query.latency_threshold, 0 =
        off): past the threshold, log AND capture a diagnostics bundle so
        the slow execution's trace is inspectable after the fact."""
        from ..utils import settings

        thresh = settings.get("sql.log.slow_query.latency_threshold")
        if not thresh or elapsed_s < float(thresh):
            return
        from ..utils import log
        from . import diagnostics

        bundle = diagnostics.capture(
            self, text, elapsed_s=elapsed_s, span=span,
            trigger="slow_query", error=error)
        log.warning(log.SQL_EXEC, "slow query",
                    elapsed_ms=round(elapsed_s * 1e3, 1),
                    bundle=bundle.get("id"), stmt=text.strip()[:120])

    def _statement_deadline(self) -> float | None:
        """time.monotonic() deadline from the statement_timeout session
        var (milliseconds, postgres convention; 0/unset = none). Handed
        to admission so queue-wait spends the same budget as execution —
        a statement must not wait out its whole timeout in the queue and
        then start running."""
        sv = getattr(self, "_session_vars", None)
        if not sv:
            return None
        try:
            ms = float(sv.get("statement_timeout", 0) or 0)
        except (TypeError, ValueError):
            return None
        if ms <= 0:
            return None
        import time as _time

        return _time.monotonic() + ms / 1e3

    def _dispatch(self, text: str):
        from .binder import begin_statement

        begin_statement()  # now()/current_date fold per statement
        handled = self._maybe_settings_stmt(text)
        if handled is None:
            handled = self._maybe_admin_stmt(text)
        if handled is None:
            handled = self._maybe_session_var_stmt(text)
        if handled is not None:
            return handled
        from . import matview

        handled = matview.maybe_matview_stmt(self, text)
        if handled is not None:
            return handled
        if self._txn is None:
            # standing views refresh BEFORE the plan-cache fast path: a
            # memoized statement over a view must still see the frontier
            # as of statement start (a refresh bumps the catalog version,
            # which re-keys any plan the refresh staled)
            matview.refresh_for_text(self.catalog, text)
        if text.lstrip()[:7].lower() == "explain":
            from . import explain

            lines = explain(self.catalog, text, session=self).splitlines()
            return {"info": np.array(lines, dtype=object)}
        if self._txn is None:
            # exact-text fast path: a verbatim repeat SELECT skips even
            # parse/bind and runs its cached prepared plan directly
            from . import plancache

            self._set_phase("executing")
            m = plancache.run_memoized_ex(self.catalog, text)
            if m is not None:
                res, fp = m
                self._last_fp = fp or None
                return res
        self._set_phase("parsing")
        from ..utils import tracing

        with tracing.leaf_span("sql.parse"):
            stmt = P.parse_statement(text)
        if isinstance(stmt, P.Select):
            return self._select(stmt, text)
        if isinstance(stmt, (P.CreateTable, P.AlterTable, P.CreateIndex,
                             P.DropIndex)) and self._txn is not None:
            raise BindError(
                "DDL inside an explicit transaction is not supported"
            )
        if isinstance(stmt, P.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, P.AlterTable):
            return self._alter_table(stmt)
        if isinstance(stmt, P.CreateIndex):
            return self._create_index(stmt)
        if isinstance(stmt, P.DropIndex):
            return self._drop_index(stmt)
        if isinstance(stmt, P.Insert):
            return self._insert(stmt)
        if isinstance(stmt, P.Update):
            return self._update(stmt)
        if isinstance(stmt, P.Delete):
            return self._delete(stmt)
        raise BindError(f"unsupported statement {type(stmt).__name__}")

    # session variables (sessiondata vars.go role): drivers SET these at
    # connect time (extra_float_digits, application_name, ...); SET stores
    # any name tolerantly so every driver's startup script succeeds, SHOW
    # answers known vars and stored ones
    _SESSION_VAR_DEFAULTS = {
        "application_name": "",
        "client_encoding": "UTF8",
        "extra_float_digits": "3",
        "search_path": "public",
        "statement_timeout": "0",
        "timezone": "UTC",
        "datestyle": "ISO",
        "vectorize": "on",
        "distsql": "auto",
    }

    def _maybe_session_var_stmt(self, text: str):
        import re as _re

        import numpy as _np

        t = text.strip().rstrip(";")
        m = _re.match(
            r"(?is)^set\s+(?:session\s+)?([a-z_][a-z0-9_]*)\s*"
            r"(?:=|\s+to\s+)\s*(.+)$", t)
        if m and m.group(1).lower() not in ("cluster",):
            name = m.group(1).lower()
            raw = m.group(2).strip().strip("'\"")
            if not hasattr(self, "_session_vars"):
                self._session_vars = {}
            self._session_vars[name] = raw
            if name == "application_name":
                from . import activity

                activity.set_application_name(self._session_id, raw)
            return {"set": name}
        m = _re.match(r"(?is)^show\s+([a-z_][a-z0-9_]*)$", t)
        if m:
            name = m.group(1).lower()
            vars_ = getattr(self, "_session_vars", {})
            if (name not in vars_
                    and name not in self._SESSION_VAR_DEFAULTS):
                raise BindError(f"unrecognized configuration parameter "
                                f"{name!r}")
            val = vars_.get(name, self._SESSION_VAR_DEFAULTS.get(name, ""))
            return {name: _np.array([val], dtype=object)}
        return None

    # -- explicit transactions (the conn_executor txn state machine,
    # reference: pkg/sql/conn_executor.go:2323 + conn_fsm.go, reduced to
    # NoTxn / Open / Aborted) ------------------------------------------------

    def _maybe_txn_stmt(self, text: str):
        import re as _re

        t = text.strip().rstrip(";").lower()
        if _re.match(r"^(begin|start)(\s+transaction)?$", t):
            if self._txn is not None:
                raise BindError("there is already a transaction in progress")
            self._txn = self.db.new_txn()
            self._txn_aborted = False
            return {"begin": True}
        if _re.match(r"^(commit|end)(\s+transaction)?$", t):
            if self._txn is None:
                return {"warning": "there is no transaction in progress"}
            txn, self._txn = self._txn, None
            if self._txn_aborted:
                # COMMIT of an aborted txn rolls back (postgres semantics)
                self._txn_aborted = False
                txn.rollback()
                return {"rollback": True}
            # a commit-time refresh failure rolls back inside commit() and
            # raises the retryable error (CRDB 40001 shape): the client
            # must restart the whole block
            txn.commit()
            return {"commit": True}
        if _re.match(r"^(rollback|abort)(\s+transaction)?$", t):
            if self._txn is None:
                return {"warning": "there is no transaction in progress"}
            txn, self._txn = self._txn, None
            self._txn_aborted = False
            txn.rollback()
            return {"rollback": True}
        return None

    def _run_write(self, op):
        """Run a DML closure: auto-commit via DB.txn retries outside an
        explicit transaction; inside one, run against the session txn with
        NO implicit retry — a retryable conflict surfaces to the client as
        a restart-the-block error and the txn enters the Aborted state
        (the reference cannot replay client-driven statements either).

        The closure's columnar scans (``_affected``) surface foreign
        intents as WriteIntentError; that is the same retryable conflict
        Txn.get/scan convert, so convert it here too — otherwise the
        40001 retry loop every client wraps around blocks never fires."""

        def guarded(txn):
            try:
                return op(txn)
            except WriteIntentError as e:
                raise TransactionRetryError(
                    f"conflicting intent on {e.keys}"
                ) from e

        if self._txn is None:
            return self.db.txn(guarded)
        try:
            return guarded(self._txn)
        except TransactionRetryError:
            self._txn_aborted = True
            raise

    def _read_as(self, txn):
        """Context: this thread's KV-backed columnar scans read AT txn's
        snapshot AS txn (own intents visible, foreign intents conflict).
        The context is the thread's, not the shared tables': another
        connection's statement meanwhile reads at its own snapshot."""
        return reading_as(txn)

    def _select(self, stmt: P.Select, text: str | None = None):
        if self._txn is None:
            # the prepared-plan cache path: repeat statements (identical
            # structure, any numeric literals — the pgwire extended
            # protocol's Parse/Bind/Execute shape after literal inlining)
            # rebind into a cached operator tree with zero new compiles
            from ..utils import tracing
            from . import plancache

            self._set_phase("binding")
            with tracing.leaf_span("sql.bind"):
                rel = Binder(self.catalog).bind(stmt)
            # a plan matching a standing view's shape + literals serves
            # from the view's state (autocommit only: an explicit txn
            # reads at ITS snapshot, not the view frontier)
            from . import matview

            rel, _mv = matview.maybe_rewrite(self.catalog, rel)
            self._set_phase("executing")
            res, _, fp = plancache.run_cached_ex(rel, text=text)
            self._last_fp = fp or None
            return res
        # in-txn SELECT: scans read at the txn snapshot, and every scanned
        # table's span lands in the txn's read set for commit-time refresh.
        # The plan runs through the plan cache too (the reference runs a
        # fresh tree: a new signature, a capture on the card, each time)
        from . import plancache

        txn = self._txn
        with self._read_as(txn):
            rel = Binder(self.catalog).bind(stmt)
            for t in self._scanned_kv_tables(rel.plan):
                from ..storage import rowcodec as _rc

                start, end = _rc.table_span(t.table_id)
                txn.note_read_span(start, end)
            try:
                res, _, fp = plancache.run_cached_ex(rel, text=text)
                self._last_fp = fp or None
                return res
            except WriteIntentError as e:
                self._txn_aborted = True
                raise TransactionRetryError(
                    f"conflicting intent on {e.keys}"
                ) from e

    def _scanned_kv_tables(self, plan):
        """KVTables named by TableScan nodes anywhere in a plan tree."""
        from ..plan import spec as S

        out = []
        if isinstance(plan, S.TableScan):
            t = self.catalog.tables.get(plan.table)
            if isinstance(t, KVTable):
                out.append(t)
        for f in ("input", "probe", "build"):
            child = getattr(plan, f, None)
            if child is not None:
                out.extend(self._scanned_kv_tables(child))
        for child in getattr(plan, "inputs", ()) or ():
            out.extend(self._scanned_kv_tables(child))
        return out

    @staticmethod
    def _maybe_settings_stmt(text: str):
        """SET CLUSTER SETTING name = value / SHOW CLUSTER SETTING[S] — the
        pkg/settings SQL surface (registry.go; settings are SQL-updatable
        in the reference and gossiped; process-local here)."""
        import re as _re

        from ..utils import settings as _settings

        t = text.strip().rstrip(";")
        m = _re.match(
            r"(?is)^set\s+cluster\s+setting\s+([a-z0-9_.]+)\s*=\s*(.+)$", t)
        if m:
            name, raw = m.group(1), m.group(2).strip()
            reg = _settings.all_settings()
            if name not in reg:
                raise BindError(f"unknown cluster setting {name!r}")
            kind = reg[name].kind
            if kind == "bool":
                val = raw.lower() in ("true", "on", "1")
            elif kind == "int":
                val = int(raw)
            elif kind == "float":
                val = float(raw)
            else:
                val = raw.strip("'")
            _settings.set(name, val)
            return {"set": name}
        m = _re.match(r"(?is)^show\s+cluster\s+setting\s+([a-z0-9_.]+)$", t)
        if m:
            name = m.group(1)
            reg = _settings.all_settings()
            if name not in reg:
                raise BindError(f"unknown cluster setting {name!r}")
            import numpy as _np

            return {"variable": _np.array([name], dtype=object),
                    "value": _np.array([str(reg[name].get())], dtype=object)}
        if _re.match(r"(?is)^show\s+cluster\s+settings$", t):
            import numpy as _np

            reg = _settings.all_settings()
            names = sorted(reg)
            return {
                "variable": _np.array(names, dtype=object),
                "value": _np.array([str(reg[n].get()) for n in names],
                                   dtype=object),
            }
        return None

    def _maybe_tenant_stmt(self, t: str):
        """CREATE/DROP/SHOW/ALTER TENANT — the system tenant's DDL surface
        (reference: SQL tenant builtins + tenantcapabilities; reduced to
        the capability grammar the capability set here supports)."""
        import re as _re

        import numpy as _np

        from ..kv.tenant import TenantError, TenantRegistry

        def require_system():
            if self.tenant is not None and self.tenant.name != "system":
                raise TenantError(
                    "tenant DDL requires the system tenant"
                )
            reg = TenantRegistry(self.db)
            reg.bootstrap()
            return reg

        m = _re.match(r"(?is)^create\s+tenant\s+'?([a-z0-9_]+)'?$", t)
        if m:
            rec = require_system().create(m.group(1))
            return {"tenant_id": rec.tenant_id, "name": rec.name}
        m = _re.match(r"(?is)^drop\s+tenant\s+'?([a-z0-9_]+)'?$", t)
        if m:
            require_system().drop(m.group(1))
            return {"dropped": m.group(1)}
        if _re.match(r"(?is)^show\s+tenants$", t):
            recs = require_system().list()
            return {
                "id": _np.array([r.tenant_id for r in recs],
                                dtype=_np.int64),
                "name": _np.array([r.name for r in recs], dtype=object),
                "capabilities": _np.array(
                    [",".join(f"{k}={v}" for k, v in sorted(r.caps.items()))
                     for r in recs], dtype=object),
            }
        m = _re.match(
            r"(?is)^alter\s+tenant\s+'?([a-z0-9_]+)'?\s+"
            r"(grant|revoke)\s+capability\s+([a-z0-9_]+)$", t)
        if m:
            cap = m.group(3).lower()
            if cap not in ("can_create_table", "can_backup"):
                # GRANT/REVOKE writes booleans: numeric caps (max_tables)
                # would silently corrupt
                raise TenantError(f"unknown boolean capability {cap!r}")
            rec = require_system().set_capability(
                m.group(1), cap,
                m.group(2).lower() == "grant",
            )
            return {"tenant": rec.name,
                    m.group(3).lower(): rec.caps[m.group(3).lower()]}
        return None

    def _maybe_admin_stmt(self, text: str):
        """Tenant DDL, BACKUP TO '<uri>' / RESTORE FROM '<uri>', SHOW TABLES
        / COLUMNS / STATISTICS / RANGES / STATEMENTS / CONTENTION / JOBS
        and ANALYZE. BACKUP runs as a job, exactly the reference's shape;
        RESTORE swaps the engine state in from the checkpoint, on this
        session's device, and reloads the table descriptors and
        dictionaries."""
        import re as _re

        t = text.strip().rstrip(";")
        handled = self._maybe_tenant_stmt(t)
        if handled is not None:
            return handled
        m = _re.match(r"(?is)^backup\s+to\s+'([^']+)'$", t)
        if m:
            if self.tenant is not None:
                from ..kv.tenant import check_capability

                check_capability(self.tenant, "can_backup")
            from ..kv.jobs import register_builtin_jobs

            reg = self._jobs_registry()
            register_builtin_jobs(reg)
            job = reg.create("backup", {"path": m.group(1)})
            done = reg.adopt_and_resume(job.job_id)
            return {"job_id": done.job_id, "state": done.state}
        m = _re.match(r"(?is)^restore\s+from\s+'([^']+)'$", t)
        if m:
            if self.tenant is not None and self.tenant.name != "system":
                from ..kv.tenant import CapabilityError

                # RESTORE swaps the SHARED engine state — system only
                raise CapabilityError(
                    "RESTORE requires the system tenant (it replaces the "
                    "shared store)"
                )
            from ..utils.external_storage import resolve_dir_uri

            self.db.engine = Engine.open_checkpoint(
                resolve_dir_uri(m.group(1)), device=self.catalog.device)
            # schemas are data: rebuild the catalog from the restored
            # descriptors (tables created after the backup disappear;
            # tables present in the backup return even into a fresh session)
            from ..kv.table import load_catalog_from_engine

            for name in [n for n, tbl in self.catalog.tables.items()
                         if isinstance(tbl, KVTable)]:
                del self.catalog.tables[name]
            load_catalog_from_engine(self.catalog, self.db)
            self._invalidate_plans()
            return {"restored": m.group(1)}
        if _re.match(r"(?is)^show\s+tables$", t):
            import numpy as _np

            # "__"-prefixed names are engine-internal (the FROM-less
            # SELECT dual relation)
            names = sorted(n for n in self.catalog.tables
                           if not n.startswith("__"))
            return {"table_name": _np.array(names, dtype=object)}
        m = _re.match(r"(?is)^show\s+columns\s+from\s+([a-z0-9_]+)$", t)
        if m:
            import numpy as _np

            tbl = self.catalog.tables.get(m.group(1))
            if tbl is None:
                raise BindError(f"unknown table {m.group(1)!r}")
            return {
                "column_name": _np.array(tbl.schema.names, dtype=object),
                "data_type": _np.array(
                    [str(ty) for ty in tbl.schema.types], dtype=object),
            }
        m = _re.match(
            r"(?is)^(?:analyze|create\s+statistics\s+\w+\s+from)\s+"
            r"([a-z0-9_]+)$", t)
        if m:
            from . import stats as stats_mod

            name = m.group(1)
            tbl = self.catalog.tables.get(name)
            if tbl is None:
                raise BindError(f"unknown table {name!r}")
            st = stats_mod.analyze_table(tbl)
            tbl.set_stats(st)
            if isinstance(tbl, KVTable):
                stats_mod.save_kv_stats(self.db, tbl.table_id, st)
            # cached plans baked the OLD stats into kernel shapes
            # (bit-packed sort keys, broadcast choices) — re-key them
            self._invalidate_plans()
            return {"analyzed": name, "rows": st.row_count}
        m = _re.match(r"(?is)^show\s+statistics\s+for\s+table\s+"
                      r"([a-z0-9_]+)$", t)
        if m:
            import numpy as _np

            tbl = self.catalog.tables.get(m.group(1))
            if tbl is None:
                raise BindError(f"unknown table {m.group(1)!r}")
            st = getattr(tbl, "table_stats", None)
            if st is None:
                return {"column_name": _np.array([], dtype=object)}
            names = list(st.cols)
            return {
                "column_name": _np.array(names, dtype=object),
                "row_count": _np.full(len(names), st.row_count),
                "distinct_count": _np.array(
                    [st.cols[n].ndv for n in names]),
                "null_count": _np.array(
                    [st.cols[n].null_count for n in names]),
            }
        if _re.match(r"(?is)^show\s+ranges$", t):
            import numpy as _np

            descs = []
            meta = getattr(self.db.engine, "meta", None)
            if meta is not None:  # DistSender-backed: real descriptors
                descs = meta.snapshot()
            if descs:
                return {
                    "range_id": _np.array([d.range_id for d in descs]),
                    "start_key": _np.array(
                        [d.start_key.decode("utf-8", "replace")
                         for d in descs], dtype=object),
                    "end_key": _np.array(
                        [(d.end_key.decode("utf-8", "replace")
                          if d.end_key is not None else "") for d in descs],
                        dtype=object),
                    "store_id": _np.array([d.store_id for d in descs]),
                }
            # single-store DB: one whole-keyspace range (store 1)
            return {
                "range_id": _np.array([1]),
                "start_key": _np.array([""], dtype=object),
                "end_key": _np.array([""], dtype=object),
                "store_id": _np.array([1]),
            }
        if _re.match(r"(?is)^show\s+statements$", t):
            import numpy as _np

            from . import sqlstats

            rows = sqlstats.DEFAULT.rows_payload()  # one consistent snapshot
            return {
                "fingerprint": _np.array(
                    [r["fingerprint"] for r in rows], dtype=object),
                "count": _np.array([r["count"] for r in rows]),
                "mean_ms": _np.array([r["meanMs"] for r in rows]),
                "max_ms": _np.array([r["maxMs"] for r in rows]),
                "rows": _np.array([r["rows"] for r in rows]),
                "errors": _np.array([r["errors"] for r in rows]),
            }
        if _re.match(r"(?is)^show\s+contention$", t):
            import numpy as _np

            from ..kv.contention import DEFAULT as _cont

            rows = _cont.rows_payload()
            return {
                "key": _np.array([r["key"] for r in rows], dtype=object),
                "count": _np.array([r["count"] for r in rows]),
                "last_holder_txn": _np.array(
                    [r["lastHolderTxn"] for r in rows]),
                "num_waiters": _np.array([r["numWaiters"] for r in rows]),
            }
        if _re.match(r"(?is)^show\s+jobs$", t):
            import numpy as _np

            reg = self._jobs_registry()
            jobs = reg.jobs()
            return {
                "job_id": _np.array([j.job_id for j in jobs]),
                "job_type": _np.array([j.job_type for j in jobs],
                                      dtype=object),
                "state": _np.array([j.state for j in jobs], dtype=object),
            }
        return None

    def _jobs_registry(self):
        from ..kv.jobs import Registry

        if getattr(self, "_jobs", None) is None:
            self._jobs = Registry(self.db)
        return self._jobs

    # -- DDL -----------------------------------------------------------------

    def _invalidate_plans(self) -> None:
        """Schema-change barrier: bump the catalog version (re-keying every
        cached plan), eagerly sweep the dead entries, and — when
        ``sql.plan_cache.warmup.enabled`` — kick the background warmup
        thread so hot statements recompile off the serving path."""
        from . import plancache

        self.catalog.bump_version()
        plancache.cache_for(self.catalog).invalidate(self.catalog.version)
        plancache.start_warmup(self)

    def _create_table(self, stmt: P.CreateTable):
        if stmt.name.startswith("__"):
            raise BindError(
                "table names starting with '__' are reserved"
            )
        if stmt.name in self.catalog.tables:
            raise BindError(f"table {stmt.name!r} already exists")
        names = tuple(c.name for c in stmt.columns)
        types = tuple(_col_type(c) for c in stmt.columns)
        pks = [c.name for c in stmt.columns if c.primary_key]
        if len(pks) != 1:
            raise BindError("exactly one PRIMARY KEY column is required")
        schema = T.Schema(names, types)
        need = rowcodec.value_width(schema)
        if self.db.engine.val_width < need:
            raise BindError(
                f"row width {need} exceeds engine value width "
                f"{self.db.engine.val_width}; open the Session with "
                f"val_width>={need}"
            )
        id_range = None
        if self.tenant is not None:
            from ..kv.tenant import CapabilityError, check_capability

            check_capability(self.tenant, "can_create_table")
            n_tables = sum(1 for t in self.catalog.tables.values()
                           if isinstance(t, KVTable))
            if n_tables >= int(self.tenant.caps.get("max_tables", 1 << 30)):
                raise CapabilityError(
                    f"tenant {self.tenant.name!r} reached its max_tables "
                    f"({self.tenant.caps['max_tables']})"
                )
            id_range = (self.tenant.id_lo, self.tenant.id_hi)
        create_kv_table(self.catalog, self.db, stmt.name, schema,
                        pk=pks[0], id_range=id_range)
        self._invalidate_plans()
        return {"created": stmt.name}

    def _alter_table(self, stmt: P.AlterTable):
        """ALTER TABLE as a schema_change job: validate, create the job,
        run the checkpointed backfill, swap the descriptor (the reference's
        schema changes are jobs for exactly this crash-resume reason)."""
        from .schemachange import plan_alter, register_schema_change_job

        payload = plan_alter(self.catalog, self.db, stmt)
        reg = self._jobs_registry()
        register_schema_change_job(reg, self.catalog)
        job = reg.create("schema_change", payload)
        done = reg.adopt_and_resume(job.job_id)
        if done.state != "succeeded":
            raise BindError(
                f"schema change failed: {done.error or done.state}"
            )
        self._invalidate_plans()
        return {"altered": stmt.name, "job_id": done.job_id}

    def _create_index(self, stmt: P.CreateIndex):
        """CREATE INDEX as a create_index job: chunked checkpointed entry
        backfill, then a fenced descriptor swap (pkg/sql/backfill.go
        discipline, same machinery as ALTER TABLE)."""
        from ..kv.index import plan_create_index, register_create_index_job

        id_range = ((self.tenant.id_lo, self.tenant.id_hi)
                    if self.tenant is not None else None)
        payload = plan_create_index(self.catalog, self.db, stmt,
                                    id_range=id_range)
        reg = self._jobs_registry()
        register_create_index_job(reg, self.catalog)
        job = reg.create("create_index", payload)
        done = reg.adopt_and_resume(job.job_id)
        if done.state != "succeeded":
            raise BindError(
                f"CREATE INDEX failed: {done.error or done.state}"
            )
        self._invalidate_plans()
        return {"created_index": stmt.name, "job_id": done.job_id}

    def _drop_index(self, stmt: P.DropIndex):
        from ..kv.index import drop_index

        t = self._kv_table(stmt.table)
        drop_index(self.catalog, self.db, t.name, stmt.name)
        # a plan cached against the dropped index (IndexScan) must never
        # serve again — the version bump re-keys it out of existence
        self._invalidate_plans()
        return {"dropped_index": stmt.name}

    # -- DML -----------------------------------------------------------------

    def _kv_table(self, name: str) -> KVTable:
        t = self.catalog.tables.get(name)
        if t is None:
            raise BindError(f"unknown table {name!r}")
        if not isinstance(t, KVTable):
            raise BindError(
                f"table {name!r} is a static host table; DML targets "
                "KV-backed tables (CREATE TABLE)"
            )
        return t

    @staticmethod
    def _literal(e: P.Node, t: T.SQLType):
        """Evaluate a literal expression for column type t. Raises
        NotALiteral when the expression references columns (the caller may
        then route it through the engine); genuine validation errors
        (precision overflow, type mismatch) raise BindError and MUST
        propagate — swallowing them would silently reclassify an invalid
        literal as a computed expression."""
        from .binder import _fold

        e = _fold(e)
        # constant arithmetic (incl. unary minus, which parses as 0 - x)
        if isinstance(e, P.Bin) and e.op in ("+", "-", "*", "/"):
            lv = Session._literal(e.left, T.FLOAT64)
            rv = Session._literal(e.right, T.FLOAT64)
            if lv is None or rv is None:
                return None
            v = {"+": lv + rv, "-": lv - rv, "*": lv * rv,
                 "/": lv / rv}[e.op]
            e = P.NumLit(v)
        if isinstance(e, P.NullLit):
            return None
        if isinstance(e, P.NumLit):
            v = e.value
            if t.family is T.Family.DECIMAL:
                scaled = float(v) * (10 ** t.scale)
                if abs(scaled - round(scaled)) > 1e-6:
                    raise BindError(
                        f"literal {v} has more than {t.scale} decimal places"
                    )
                return int(round(scaled))
            if t.family is T.Family.FLOAT:
                return float(v)
            return int(v)
        if isinstance(e, P.DateLit):
            return int((np.datetime64(e.value) -
                        np.datetime64("1970-01-01")).astype(int))
        if isinstance(e, (P.Bin,)):
            raise NotALiteral("expression references columns")
        if isinstance(e, P.StrLit):
            if t.family is T.Family.DATE:
                # postgres coerces 'YYYY-MM-DD' literals to DATE in
                # context. Explicit 'D' unit: an unqualified datetime64
                # infers resolution from the string, so a timestamp-shaped
                # literal would silently store MINUTES as a day count
                try:
                    return int((np.datetime64(e.value, "D") -
                                np.datetime64("1970-01-01", "D")
                                ).astype(int))
                except ValueError as err:
                    raise BindError(
                        f"invalid DATE literal {e.value!r}: {err}"
                    ) from None
            if t.family is not T.Family.STRING:
                raise BindError("string literal for non-STRING column")
            return e.value  # KVTable dictionary-encodes on insert
        raise NotALiteral(f"not a literal: {e}")

    def _insert(self, stmt: P.Insert):
        t = self._kv_table(stmt.table)
        names = stmt.columns or t.schema.names
        for n in names:
            if n not in t.schema.names:
                raise BindError(f"unknown column {n!r}")
        if stmt.select is not None:
            res = Binder(self.catalog).bind(stmt.select).run()
            if len(res) != len(names):
                raise BindError(
                    f"INSERT ... SELECT produces {len(res)} columns, "
                    f"target list has {len(names)}"
                )
            cols = list(res.values())
            nrows = len(cols[0]) if cols else 0
            rows = []
            keys = list(res.keys())
            for i in range(nrows):
                rows.append({
                    names[j]: _from_result(res[keys[j]][i],
                                           t.schema.type_of(names[j]))
                    for j in range(len(names))
                })
        else:
            # columnar VALUES path (colenc discipline: encode columns, not
            # rows — the vectorized write path; sql/colenc in the
            # reference). Literals land in per-column lists and batch-
            # encode through KVTable.insert_rows.
            per_name: dict[str, list] = {n: [] for n in names}
            for vals in stmt.rows:
                if len(vals) != len(names):
                    raise BindError(
                        f"INSERT row has {len(vals)} values, expected "
                        f"{len(names)}"
                    )
                for n, v in zip(names, vals):
                    per_name[n].append(
                        self._literal(v, t.schema.type_of(n))
                    )
            missing = set(t.schema.names) - set(names)
            if missing:
                raise BindError(f"columns {sorted(missing)} need values "
                                "(defaults not supported)")
            nrows = len(stmt.rows)
            cols: dict[str, np.ndarray] = {}
            valids: dict[str, np.ndarray] = {}
            for n in names:
                vals = per_name[n]
                typ = t.schema.type_of(n)
                valid = np.array([v is not None for v in vals], dtype=bool)
                if not valid.all():
                    valids[n] = valid
                if typ.family is T.Family.STRING:
                    cols[n] = np.array(
                        ["" if v is None else v for v in vals],
                        dtype=object,
                    )
                elif typ.family is T.Family.FLOAT:
                    cols[n] = np.array(
                        [0.0 if v is None else float(v) for v in vals],
                        dtype=np.float64,
                    )
                else:
                    cols[n] = np.array(
                        [0 if v is None else int(v) for v in vals],
                        dtype=np.int64,
                    )
            if t.pk in valids:
                raise BindError("NULL primary key")

            def vop(txn):
                t.insert_rows(txn, cols, valids)

            self._run_write(vop)
            return {"rows_affected": nrows}
        missing = set(t.schema.names) - set(names)
        if missing:
            raise BindError(f"columns {sorted(missing)} need values "
                            "(defaults not supported)")

        def op(txn):
            for r in rows:
                t.insert(txn, r)

        self._run_write(op)
        return {"rows_affected": len(rows)}

    def _affected(self, t: KVTable, where: P.Node | None,
                  extra_cols: list[tuple[str, P.Node]] = ()):
        """Plan WHERE + SET expressions through the columnar engine; returns
        host rows of (pk, full current row, computed extras). The plan runs
        through the plan cache with its WHERE and SET literals as
        parameters, so a repeat of the statement with other literals
        rebinds one cached tree (the reference builds a fresh one: a new
        signature, a CUDA graph capture on the card, each time)."""
        from . import plancache

        rel = Rel.scan(self.catalog, t.name)
        if where is not None:
            binder = Binder(self.catalog)
            folded = binder._replace_scalar_subqueries(where)
            rel = rel.filter(ExprLowerer(rel).lower(folded))
        items = [(n, ExprLowerer(rel).lower(P.Ident(None, n)))
                 for n in t.schema.names]
        for name, e in extra_cols:
            items.append((f"__set_{name}", ExprLowerer(rel).lower(e)))
        rel = rel.project(items)
        res, _, _ = plancache.run_cached_ex(rel, projections=True)
        return res

    def _update(self, stmt: P.Update):
        t = self._kv_table(stmt.table)
        # literal SETs (incl. string literals, whose dictionary code may not
        # exist yet) evaluate host-side; column-referencing SETs compute
        # through the columnar engine alongside the WHERE scan
        const_sets: dict[str, object] = {}
        computed_sets: list[tuple[str, P.Node]] = []
        for col, e in stmt.sets:
            if col not in t.schema.names:
                raise BindError(f"unknown column {col!r}")
            if col == t.pk:
                raise BindError("updating the PRIMARY KEY is not supported")
            try:
                const_sets[col] = self._literal(e, t.schema.type_of(col))
            except NotALiteral:
                computed_sets.append((col, e))
        computed = {c for c, _ in computed_sets}
        pk_t = t.schema.type_of(t.pk)

        def op(txn):
            # the affected-row scan runs INSIDE the txn closure at the TXN'S
            # snapshot (own intents visible — statements earlier in an
            # explicit txn are seen), so a retry recomputes it, and each row
            # is re-read through the txn (get_row_txn tracks the read span)
            # — a writer interleaving between scan and commit fails the
            # commit-time refresh and retries instead of being silently
            # overwritten (lost update)
            with self._read_as(txn):
                res = self._affected(t, stmt.where, computed_sets)
            n = len(res[t.pk])
            written = 0
            for i in range(n):
                pk = _from_result(res[t.pk][i], pk_t)
                cur = t.get_row_txn(txn, pk)
                if cur is None:
                    continue  # deleted since the scan; refresh validates
                row = {}
                for cname, typ in zip(t.schema.names, t.schema.types):
                    if cname in computed:
                        row[cname] = _from_result(res[f"__set_{cname}"][i],
                                                  typ)
                    elif cname in const_sets:
                        row[cname] = const_sets[cname]
                    else:
                        # unmodified columns come from the TRACKED read,
                        # not the untracked scan snapshot
                        row[cname] = cur[cname]
                t.insert(txn, row)  # MVCC: a new version at the txn ts
                written += 1
            return written

        n = self._run_write(op)
        return {"rows_affected": n}

    def _delete(self, stmt: P.Delete):
        t = self._kv_table(stmt.table)
        pk_t = t.schema.type_of(t.pk)

        def op(txn):
            with self._read_as(txn):
                res = self._affected(t, stmt.where)
            deleted = 0
            for v in res[t.pk]:
                pk = _from_result(v, pk_t)
                if t.get_row_txn(txn, pk) is None:
                    continue  # already gone; the tracked read validates
                t.delete_pk(txn, pk)
                deleted += 1
            return deleted

        n = self._run_write(op)
        return {"rows_affected": n}


def _from_result(v, t: T.SQLType):
    """Convert a materialized result value back to the row-encoding domain
    (to_host descales DECIMAL to float and decodes STRING dictionaries;
    re-scale / re-encode for storage)."""
    if v is None:
        return None
    if t.family is T.Family.STRING:
        return str(v)  # KVTable dictionary-encodes on insert
    if t.family is T.Family.DECIMAL:
        return int(round(float(v) * (10 ** t.scale)))
    if t.family is T.Family.FLOAT:
        return float(v)
    if t.family is T.Family.BOOL:
        return bool(v)
    return int(v)
