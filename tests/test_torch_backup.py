"""The port's BACKUP, RESTORE and external storage
(cockroach_tpu_torch/kv/jobs.py's backup job, utils/external_storage.py,
the session's BACKUP TO / RESTORE FROM) against the reference's on the
CPU: a string dictionary rebuilt over the same engine, BACKUP / RESTORE /
SHOW JOBS through the session (tests/test_dml.py), BACKUP as a job
(tests/test_kv.py), each with every engine version byte-equal (both
stores on a ManualClock); unconfigured, unknown and escaping URIs with
the reference's errors; IMPORT's job reading a nodelocal:// CSV; and a
backup the reference wrote, restored into the port, answering as the
reference does."""

import csv
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import ManualClock as jClock
from cockroach_tpu.kv import jobs as jjobs
from cockroach_tpu.kv import table as jtable
from cockroach_tpu.sql import Session as jSession
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu.utils import external_storage as jext
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import ManualClock as tClock
from cockroach_tpu_torch.kv import jobs as tjobs
from cockroach_tpu_torch.kv import table as ttable
from cockroach_tpu_torch.sql import Session as tSession
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import external_storage as text


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


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


J = SimpleNamespace(
    jobs=jjobs, table=jtable, ext=jext, Engine=jEngine,
    db=lambda kw=24, vw=256, mt=4096: jDB(
        jEngine(key_width=kw, val_width=vw, memtable_size=mt), jClock()),
    session=lambda db: jSession(db=db),
    open_checkpoint=lambda p: jEngine.open_checkpoint(p))
T = SimpleNamespace(
    jobs=tjobs, table=ttable, ext=text, Engine=tEngine,
    db=lambda kw=24, vw=256, mt=4096: tDB(
        tEngine(key_width=kw, val_width=vw, memtable_size=mt,
                device="cpu"), tClock()),
    session=lambda db: tSession(db=db, device="cpu"),
    open_checkpoint=lambda p: tEngine.open_checkpoint(p, device="cpu"))

FIELDS = ("key", "ts", "seq", "txn", "tomb", "value", "vlen")


def engines_equal(jdb, tdb):
    got = tdb.engine.export_span(None, None)
    want = jdb.engine.export_span(None, None)
    for k in FIELDS:
        assert np.asarray(got[k]).tobytes() == np.asarray(
            want[k]).tobytes(), k


def outcome(fn, *a):
    """A call's columns or its error's class and text."""
    try:
        out = fn(*a)
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return ("err", type(e).__name__, str(e))
    return ("ok", {k: np.asarray(v).tolist() for k, v in out.items()})


def string_dictionary_survives_restore(ns, path):
    """The dictionary is data: a KVTable rebuilt over the same engine
    recovers its codes from the companion span."""
    sess = ns.session(ns.db())
    sess.execute("create table t (id int primary key, tag string)")
    sess.execute("insert into t values (1, 'x'), (2, 'y'), (3, 'x')")
    old = sess.catalog.tables["t"]
    reopened = ns.table.KVTable(sess.db, "t", old.schema, old.pk,
                                old.table_id, old.dict_table_id)
    assert reopened._dicts[1].values == ["x", "y"]
    assert reopened.get_row(3)["tag"] == "x"
    return sess.db, [reopened._dicts[1].values, reopened.get_row(3)]


def backup_restore_sql_surface(ns, path):
    """BACKUP TO / RESTORE FROM / SHOW JOBS through the session: state
    written after the backup disappears on restore, string dictionaries
    reload from the restored spans."""
    sess = ns.session(ns.db())
    out = []
    for stmt in ("create table t (a int primary key, tag string)",
                 "insert into t values (1, 'keep'), (2, 'keep2')",
                 f"backup to '{path}'",
                 "insert into t values (3, 'lost-after-restore')",
                 "select count(*) as n from t",
                 f"restore from '{path}'",
                 "select a, tag from t order by a",
                 "show jobs"):
        out.append(outcome(sess.execute, stmt))
    assert out[2][1]["state"] == "succeeded"
    assert out[4][1]["n"] == [3]
    assert out[6][1] == {"a": [1, 2], "tag": ["keep", "keep2"]}
    assert "backup" in out[7][1]["job_type"]
    return sess.db, out


def backup_as_a_job(ns, path):
    """BACKUP rides the jobs frame: durable record, engine checkpoint,
    restore from the produced artifact."""
    db = ns.db(kw=16, mt=64)
    db.txn(lambda t: [t.put(b"k%03d" % i, b"v%03d" % i) for i in range(50)])
    reg = ns.jobs.Registry(db)
    ns.jobs.register_builtin_jobs(reg)
    job = reg.create("backup", {"path": path})
    done = reg.adopt_and_resume(job.job_id)
    assert done.state == "succeeded" and done.progress["path"] == path
    restored = ns.open_checkpoint(path)
    got = restored.scan(b"k", b"l", ts=db.clock.now())
    assert len(got) == 50 and got[0] == (b"k000", b"v000")
    return db, [repr(done), got]


SCENARIOS = (
    string_dictionary_survives_restore,
    backup_restore_sql_surface,
    backup_as_a_job,
)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_backup_equals_reference(scenario, tmp_path):
    path = str(tmp_path / "bk")  # one path: the job records hold it
    jdb, want = scenario(J, path)
    tdb, got = scenario(T, path)
    assert got == want
    engines_equal(jdb, tdb)


@pytest.mark.parametrize("uri", [
    "s3://bucket/backup",
    "gs://bucket/backup",
    "ftp://host/backup",
    "nodelocal://1/../escape",
    "nodelocal://1/a/../../escape",
])
def test_bad_uris_raise_reference_errors(uri, nodelocal):
    """Cloud schemes fail with the build's guidance, unknown schemes and
    paths that leave the storage root are refused — through the storage
    registry and through BACKUP, whose job ends failed."""
    outs, dbs = [], []
    for ns in (J, T):
        sess = ns.session(ns.db())
        outs.append((outcome(lambda: {"d": [ns.ext.resolve_dir_uri(uri)]}),
                     outcome(sess.execute, f"backup to '{uri}'"),
                     [(j.job_type, j.state, j.error)
                      for j in sess._jobs_registry().jobs()]))
        dbs.append(sess.db)
    want, got = outs
    assert got == want
    assert want[0][0] == "err" and want[1][0] == "err"
    assert want[2][0][1] == "failed"
    engines_equal(*dbs)


def test_import_reads_a_nodelocal_csv(nodelocal):
    """IMPORT INTO items CSV DATA ('nodelocal://1/x.csv') as the import
    job: both packages read the file through external storage and hold
    the same versions after it."""
    n = 300
    with open(nodelocal / "x.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["id", "qty", "tag"])
        w.writeheader()
        for i in range(n):
            w.writerow({"id": i, "qty": "" if i % 11 == 0 else i % 97,
                        "tag": f"t{i % 7}"})
    dbs, rows = [], []
    for ns in (J, T):
        sess = ns.session(ns.db())
        sess.execute("create table items (id int primary key, qty int, "
                     "tag string)")
        reg = ns.jobs.Registry(sess.db)
        ns.jobs.register_import_job(reg, sess.catalog)
        done = reg.adopt_and_resume(reg.create(
            "import", {"table": "items",
                       "path": "nodelocal://1/x.csv"}).job_id)
        assert done.state == "succeeded" and done.progress["rows"] == n
        rows.append(outcome(sess.execute, "select tag, count(*) as n, "
                            "sum(qty) as q from items group by tag "
                            "order by tag"))
        dbs.append(sess.db)
    assert rows[1] == rows[0]
    assert rows[0][1]["n"] == [43, 43, 43, 43, 43, 43, 42]
    engines_equal(*dbs)


def test_reference_backup_restores_into_the_port(tmp_path):
    """A checkpoint the reference's BACKUP wrote, RESTOREd by a port
    session, answers every query as the reference's own RESTORE does."""
    path = str(tmp_path / "ref")
    j = J.session(J.db())
    for stmt in ("create table acct (id int primary key, bal "
                 "decimal(12, 2), tag string, day date)",
                 "insert into acct values (1, 10.50, 'a', '1998-01-02'), "
                 "(2, 20.00, 'b', '1998-03-04'), (3, 0.25, 'a', "
                 "'1998-05-06')",
                 "create table kv (k int primary key, v float)",
                 "insert into kv values (1, 0.5), (2, 1.5), (3, 2.5)"):
        j.execute(stmt)
    assert j.execute(f"backup to '{path}'")["state"] == "succeeded"
    j.execute("insert into kv values (4, 3.5)")
    t = T.session(T.db())
    # a restoring node's clock is past the backup's timestamps, as a real
    # clock would be; a manual one behind them reads a mix of versions in
    # both packages (neither RESTORE forwards the clock; ROADMAP Queue 3)
    t.db.clock.advance(1 << 20)
    t.execute("create table other (x int primary key)")
    assert t.execute(f"restore from '{path}'") == {"restored": path}
    j.execute(f"restore from '{path}'")
    assert sorted(t.catalog.tables) == sorted(j.catalog.tables)
    for stmt in ("select id, bal, tag, day from acct order by id",
                 "select tag, sum(bal) as s, count(*) as n from acct "
                 "group by tag order by tag",
                 "select k, v from kv order by k",
                 "show jobs"):
        assert outcome(t.execute, stmt) == outcome(j.execute, stmt), stmt
    assert t.db.engine.device.type == "cpu"
    t.execute("insert into kv values (4, 3.5)")
    assert t.execute("select count(*) as n from kv")["n"].tolist() == [4]
