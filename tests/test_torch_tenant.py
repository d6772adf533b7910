"""The port's tenants (cockroach_tpu_torch/kv/tenant.py and the session's
tenant scoping) against the reference's on the CPU: the 6 scenarios of
tests/test_tenant.py through both packages, every statement's result or
error (class and text) equal and every engine version byte-equal
afterwards (both stores on a ManualClock); and a tenant's admission
capabilities binding when a session opens as it
(tests/test_admission_tenants.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import ManualClock as jClock
from cockroach_tpu.kv import tenant as jtenant
from cockroach_tpu.sql import Session as jSession
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu.utils import admission as jadmission
from cockroach_tpu.utils import external_storage as jext
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import ManualClock as tClock
from cockroach_tpu_torch.kv import tenant as ttenant
from cockroach_tpu_torch.sql import Session as tSession
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import admission as tadmission
from cockroach_tpu_torch.utils import external_storage as text


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


J = SimpleNamespace(
    tenant=jtenant, admission=jadmission,
    db=lambda: jDB(jEngine(key_width=24, val_width=128,
                           memtable_size=4096), jClock()),
    session=lambda db, **k: jSession(db=db, **k))
T = SimpleNamespace(
    tenant=ttenant, admission=tadmission,
    db=lambda: tDB(tEngine(key_width=24, val_width=128, memtable_size=4096,
                           device="cpu"), tClock()),
    session=lambda db, **k: tSession(db=db, device="cpu", **k))

@pytest.fixture
def nodelocal(tmp_path):
    """Both packages' nodelocal:// base at one temporary directory, the
    previous bases restored after."""
    saved = [(ext, ext._NODELOCAL_BASE) for ext in (jext, text)]
    for ext, _ in saved:
        ext.set_nodelocal_base(str(tmp_path))
    yield tmp_path
    for ext, base in saved:
        ext.set_nodelocal_base(base)


FIELDS = ("key", "ts", "seq", "txn", "tomb", "value", "vlen")


class Log(list):
    """A scenario's transcript: each call's result or its error."""

    def call(self, fn, *a):
        try:
            out = fn(*a)
        except Exception as e:  # noqa: BLE001 - the error is the outcome
            self.append(("err", type(e).__name__, str(e)))
            return e
        self.append(("ok", {k: np.asarray(v).tolist() for k, v in out.items()}
                     if isinstance(out, dict) else repr(out)))
        return out


def engines_equal(jdb, tdb):
    got = tdb.engine.export_span(None, None)
    want = jdb.engine.export_span(None, None)
    for k in FIELDS:
        assert np.asarray(got[k]).tobytes() == np.asarray(
            want[k]).tobytes(), k


def registry_create_list_drop(ns, log):
    db = ns.db()
    reg = ns.tenant.TenantRegistry(db)
    log.call(reg.bootstrap)
    a = log.call(reg.create, "acme")
    b = log.call(reg.create, "bravo")
    assert a.tenant_id == 2 and b.tenant_id == 3 and a.id_hi < b.id_lo
    assert {r.name for r in log.call(reg.list)} == {
        "system", "acme", "bravo"}
    assert isinstance(log.call(reg.create, "acme"), ns.tenant.TenantError)
    log.call(reg.drop, "bravo")
    assert {r.name for r in log.call(reg.list)} == {"system", "acme"}
    assert isinstance(log.call(reg.drop, "system"), ns.tenant.TenantError)
    return db


def tenant_keyspace_isolation(ns, log):
    db = ns.db()
    sys_s = ns.session(db)
    log.call(sys_s.execute, "CREATE TENANT acme")
    log.call(sys_s.execute, "CREATE TENANT bravo")
    sa = ns.session(db, tenant="acme")
    sb = ns.session(db, tenant="bravo")
    for s, v in ((sa, 100), (sb, 200)):
        log.call(s.execute, "CREATE TABLE t (k INT PRIMARY KEY, v INT)")
        log.call(s.execute, f"INSERT INTO t VALUES (1, {v})")
    assert list(log.call(sa.execute, "SELECT v FROM t")["v"]) == [100]
    assert list(log.call(sb.execute, "SELECT v FROM t")["v"]) == [200]
    ta, tb = sa.catalog.tables["t"], sb.catalog.tables["t"]
    log.append(("ids", ta.table_id, tb.table_id))
    assert ta.table_id != tb.table_id
    sa2 = ns.session(db, tenant="acme")
    assert list(log.call(sa2.execute, "SELECT v FROM t")["v"]) == [100]
    assert set(sa2.catalog.tables) == {"t"}
    return db


def capability_gating(ns, log):
    db = ns.db()
    sys_s = ns.session(db)
    log.call(sys_s.execute, "CREATE TENANT acme")
    sa = ns.session(db, tenant="acme")
    assert isinstance(log.call(sa.execute, "BACKUP TO 'nodelocal://1/b1'"),
                      ns.tenant.CapabilityError)
    log.call(sys_s.execute, "ALTER TENANT acme GRANT CAPABILITY can_backup")
    sa2 = ns.session(db, tenant="acme")
    log.call(sa2.execute, "CREATE TABLE t (k INT PRIMARY KEY)")
    # the same path in both packages: the job record holds it
    out = log.call(sa2.execute, "BACKUP TO 'nodelocal://1/b'")
    assert out["state"] == "succeeded"
    log.call(sys_s.execute,
             "ALTER TENANT acme REVOKE CAPABILITY can_create_table")
    sa3 = ns.session(db, tenant="acme")
    assert isinstance(log.call(sa3.execute,
                               "CREATE TABLE t2 (k INT PRIMARY KEY)"),
                      ns.tenant.CapabilityError)
    return db


def max_tables_and_range_exhaustion(ns, log):
    db = ns.db()
    log.call(ns.session(db).execute, "CREATE TENANT tiny")
    s = ns.session(db, tenant="tiny")
    cap = int(s.tenant.caps["max_tables"])
    for i in range(cap):
        log.call(s.execute, f"CREATE TABLE t{i} (k INT PRIMARY KEY)")
    assert isinstance(log.call(s.execute,
                               f"CREATE TABLE t{cap} (k INT PRIMARY KEY)"),
                      ns.tenant.CapabilityError)
    return db


def tenant_ddl_requires_system(ns, log):
    db = ns.db()
    log.call(ns.session(db).execute, "CREATE TENANT acme")
    sa = ns.session(db, tenant="acme")
    for stmt in ("CREATE TENANT evil", "SHOW TENANTS"):
        assert isinstance(log.call(sa.execute, stmt), ns.tenant.TenantError)
    return db


def show_tenants(ns, log):
    db = ns.db()
    s = ns.session(db)
    log.call(s.execute, "CREATE TENANT acme")
    out = log.call(s.execute, "SHOW TENANTS")
    assert list(out["name"]) == ["system", "acme"]
    assert "can_backup=False" in out["capabilities"][1]
    return db


SCENARIOS = (
    registry_create_list_drop,
    tenant_keyspace_isolation,
    capability_gating,
    max_tables_and_range_exhaustion,
    tenant_ddl_requires_system,
    show_tenants,
)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_tenant_scenario_equals_reference(scenario, nodelocal):
    jlog, tlog = Log(), Log()
    jdb = scenario(J, jlog)
    tdb = scenario(T, tlog)
    assert tlog == jlog
    engines_equal(jdb, tdb)


def caps_bind(ns):
    """A tenant carrying admission_* capabilities gets its bucket and
    weight configured on the shared queue when a session binds as it."""
    db = ns.db()
    boot = ns.session(db)
    saved = ns.admission._SQL_QUEUE
    q = ns.admission.WorkQueue(slots=4)
    ns.admission._SQL_QUEUE = q
    try:
        reg = ns.tenant.TenantRegistry(db)
        reg.bootstrap()
        rec = reg.create("capped", caps={
            "admission_rate": 7.0, "admission_burst": 3,
            "admission_weight": 2.0})
        tsess = ns.session(db, catalog=boot.catalog, bootstrap=False,
                           tenant="capped")
        row = next(r for r in q.tenant_rows()
                   if r["tenant_id"] == rec.tenant_id)
        tsess.close()
    finally:
        ns.admission._SQL_QUEUE = saved
        boot.close()
    return db, {k: row[k] for k in ("tenant_id", "rate", "burst", "weight")}


def test_tenant_admission_caps_bind_at_session_create():
    jdb, want = caps_bind(J)
    tdb, got = caps_bind(T)
    assert got == want == {"tenant_id": 2, "rate": 7.0, "burst": 3.0,
                           "weight": 2.0}
    engines_equal(jdb, tdb)


def _fill(adm, q, noisy, arrivals):
    """Slot held, the queue (depth 1) holding a waiter of tenant `noisy`
    that has been charged three grants; then `arrivals` (tenant ids)
    admit. Returns each arrival's outcome and the queued waiter's."""
    import threading
    import time

    for _ in range(3):  # charge the noisy tenant past the others' share
        q.admit(tenant_id=noisy)
        q.release()
    q.admit(tenant_id=noisy)  # holds the slot
    got = []

    def waiter():
        try:
            got.append(("granted", q.admit(tenant_id=noisy, timeout=30)))
        except adm.AdmissionRejectedError as e:
            got.append(("rejected", e.reason))

    th = threading.Thread(target=waiter)
    th.start()
    while q.queue_depth < 1:
        time.sleep(0.001)
    out = []
    for tid in arrivals:
        try:
            q.admit(tenant_id=tid, timeout=0.05)
            out.append("queued-then-admitted")
        except adm.AdmissionRejectedError as e:
            out.append(e.reason.split(" (")[0])
    q.release()
    th.join(timeout=30)
    assert not th.is_alive()
    while q.in_use:
        q.release()
    return out, got


def test_full_queue_refuses_the_arrival():
    """With the queue full of a tenant past its fair share, an arrival of
    any tenant is refused with the same typed AdmissionRejectedError in
    both packages, and the queued waiter keeps its place and is granted."""
    t_out, t_got = _fill(tadmission, tadmission.WorkQueue(
        slots=1, max_queue_depth=1), 5, [5, 6])
    j_out, j_got = _fill(jadmission, jadmission.WorkQueue(
        slots=1, max_queue_depth=1), 5, [5, 6])
    assert t_out == j_out == ["admission queue full"] * 2
    assert t_got == j_got == [("granted", True)]


def _rate_limited_hint(adm):
    """A rate-limited tenant refused while a statement waits: its reason
    and retry hint, and the queue's suggestion for it."""
    import threading
    import time

    q = adm.WorkQueue(slots=1, max_queue_depth=8)
    q.configure_tenant(9, rate=50.0, burst=1)
    q.admit(tenant_id=9)  # takes the one token and the slot
    th = threading.Thread(target=lambda: q.admit(timeout=30))
    th.start()
    while q.queue_depth < 1:
        time.sleep(0.001)
    with pytest.raises(adm.AdmissionRejectedError) as e:
        q.admit(tenant_id=9)
    hint = q.suggest_retry_after(9)
    q.release()
    th.join(timeout=30)
    assert not th.is_alive()
    q.release()
    assert q.in_use == 0
    return e.value.reason, e.value.retry_after_s, hint


def test_rate_limited_retry_hint_is_the_bucket_refill():
    """A rate-limited tenant's retry hint is its bucket's refill time
    alone in both packages, even while statements wait (the queue-drain
    guess would be 0.1 s here)."""
    for adm in (tadmission, jadmission):
        reason, retry, hint = _rate_limited_hint(adm)
        assert reason == "tenant rate limit: token bucket empty"
        # the bucket refills one token in at most 1/50 s
        assert 0 < retry <= 0.02 + 1e-9
        assert 0 <= hint <= 0.02 + 1e-9
