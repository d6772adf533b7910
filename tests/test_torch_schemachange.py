"""The port's schema changer and jobs fencing
(cockroach_tpu_torch/sql/schemachange.py, kv/jobs.py, kv/liveness.py)
against the reference's on the CPU: the 8 scenarios of
tests/test_schemachange.py through both packages' sessions, each
statement's result or error (class and text) equal and every engine
version byte-equal afterwards (both stores on a ManualClock); the jobs'
checkpointed resume (tests/test_kv.py), a dead node's job fenced and
re-adopted and the claim CAS against a double adoption
(tests/test_node.py, as registry-level scenarios on a ManualClock); and
the one fence of a CREATE INDEX job claimed at a stale liveness epoch."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import ManualClock as jClock
from cockroach_tpu.kv import index as jindex
from cockroach_tpu.kv import jobs as jjobs
from cockroach_tpu.kv import liveness as jlive
from cockroach_tpu.kv import table as jtable
from cockroach_tpu.sql import Session as jSession
from cockroach_tpu.sql import parser as jparser
from cockroach_tpu.sql import schemachange as jsc
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import ManualClock as tClock
from cockroach_tpu_torch.kv import index as tindex
from cockroach_tpu_torch.kv import jobs as tjobs
from cockroach_tpu_torch.kv import liveness as tlive
from cockroach_tpu_torch.kv import table as ttable
from cockroach_tpu_torch.sql import Session as tSession
from cockroach_tpu_torch.sql import parser as tparser
from cockroach_tpu_torch.sql import schemachange as tsc
from cockroach_tpu_torch.storage.lsm import Engine as tEngine


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


J = SimpleNamespace(
    sc=jsc, jobs=jjobs, live=jlive, table=jtable, index=jindex,
    parse=jparser.parse_statement,
    db=lambda vw=128: jDB(jEngine(key_width=24, val_width=vw,
                                  memtable_size=4096), jClock()),
    session=lambda db: jSession(db=db))
T = SimpleNamespace(
    sc=tsc, jobs=tjobs, live=tlive, table=ttable, index=tindex,
    parse=tparser.parse_statement,
    db=lambda vw=128: tDB(tEngine(key_width=24, val_width=vw,
                                  memtable_size=4096, device="cpu"),
                          tClock()),
    session=lambda db: tSession(db=db, device="cpu"))

FIELDS = ("key", "ts", "seq", "txn", "tomb", "value", "vlen")


class Boom(Exception):
    pass


class Log(list):
    """A scenario's transcript: each statement's columns or its error."""

    def __init__(self, sess):
        super().__init__()
        self.sess = sess

    def sql(self, text):
        try:
            out = self.sess.execute(text)
        except Exception as e:  # noqa: BLE001 - the error is the outcome
            self.append((text, "err", type(e).__name__, str(e)))
            return e
        self.append((text, "ok", {k: np.asarray(v).tolist()
                                  for k, v in out.items()}))
        return out


def engines_equal(jdb, tdb):
    got = tdb.engine.export_span(None, None)
    want = jdb.engine.export_span(None, None)
    for k in FIELDS:
        assert np.asarray(got[k]).tobytes() == np.asarray(
            want[k]).tobytes(), k


def mk(ns, n=50):
    log = Log(ns.session(ns.db()))
    log.sql("create table sc (id int primary key, a int, s string)")
    log.sql("insert into sc values " + ", ".join(
        f"({i}, {i * 2}, 's{i % 3}')" for i in range(n)))
    return log


def add_column_with_default_backfills(ns):
    log = mk(ns)
    assert "altered" in log.sql("alter table sc add column b int default 7")
    got = log.sql("select count(*) as n, sum(b) as sb from sc")
    assert int(got["n"][0]) == 50 and int(got["sb"][0]) == 350
    log.sql("insert into sc values (100, 1, 'x', 9)")
    assert list(log.sql("select b from sc where id = 100")["b"]) == [9]
    assert list(log.sql("select b from sc where id = 3")["b"]) == [7]
    return log


def add_column_null_default(ns):
    log = mk(ns)
    log.sql("alter table sc add column c float")
    assert int(log.sql("select count(c) as n from sc")["n"][0]) == 0
    log.sql("update sc set c = 1.5 where id < 10")
    assert int(log.sql("select count(c) as n from sc")["n"][0]) == 10
    return log


def drop_column(ns):
    log = mk(ns)
    log.sql("alter table sc drop column a")
    assert list(log.sql("show columns from sc")["column_name"]) == [
        "id", "s"]
    got = log.sql("select s, count(*) as n from sc group by s order by s")
    assert list(got["n"]) == [17, 17, 16]
    assert set(log.sql("select * from sc where id = 1")) == {"id", "s"}
    return log


def alter_errors(ns):
    log = mk(ns)
    for stmt, frag in [
        ("alter table sc drop column id", "PRIMARY KEY"),
        ("alter table sc add column a int", "already exists"),
        ("alter table sc drop column nope", "unknown column"),
        ("alter table nope add column x int", "unknown table"),
        ("alter table sc add column y int not null", "DEFAULT"),
    ]:
        err = log.sql(stmt)
        assert isinstance(err, Exception) and frag in str(err), stmt
    return log


def backfill_resumes_from_checkpoint(ns):
    """The backfill dies after its first chunk's checkpoint; a fresh
    resume completes from it and the descriptor swaps only at the end."""
    log = mk(ns, n=900)
    sess = log.sess
    reg = sess._jobs_registry()
    ns.sc.register_schema_change_job(reg, sess.catalog)
    payload = ns.sc.plan_alter(sess.catalog, sess.db, ns.parse(
        "alter table sc add column b int default 5"))
    job = reg.create("schema_change", payload)
    real_checkpoint = reg.checkpoint
    calls = {"n": 0}

    def crashing_checkpoint(j):
        real_checkpoint(j)
        calls["n"] += 1
        if calls["n"] == 1:
            raise Boom("crash after first chunk checkpoint")

    claimed = reg._claim(job.job_id, reg.load(job.job_id))
    assert claimed is not None and claimed.state == "running"
    reg.checkpoint = crashing_checkpoint
    with pytest.raises(Boom):
        ns.sc.backfill(reg, claimed, sess.catalog)
    reg.checkpoint = real_checkpoint
    assert "b" not in sess.catalog.tables["sc"].schema.names
    saved = reg.load(job.job_id)
    log.append(("checkpoint", saved.progress))
    assert saved.progress.get("last_pk") is not None
    done = reg.adopt_and_resume(job.job_id)
    log.append(("done", done.state, done.progress))
    assert done.state == "succeeded"
    assert "b" in sess.catalog.tables["sc"].schema.names
    got = log.sql("select count(*) as n, sum(b) as sb from sc")
    assert int(got["n"][0]) == 900 and int(got["sb"][0]) == 4500
    return log


def add_string_column_with_default(ns):
    log = Log(ns.session(ns.db()))
    log.sql("create table st (id int primary key, a int)")
    log.sql("insert into st values (1, 10), (2, 20)")
    log.sql("alter table st add column tag string default 'blue'")
    got = log.sql("select tag, count(*) as n from st group by tag")
    assert list(got["tag"]) == ["blue"] and list(got["n"]) == [2]
    log.sql("insert into st values (3, 30, 'red')")
    got = log.sql(
        "select tag, count(*) as n from st group by tag order by tag")
    assert list(got["tag"]) == ["blue", "red"] and list(got["n"]) == [2, 1]
    log.sql("alter table st add column note string")
    assert int(log.sql("select count(note) as n from st")["n"][0]) == 0
    return log


def drop_resume_does_not_corrupt_surviving_string_dict(ns):
    """A crash between the dict-span remap and the descriptor swap: the
    resume must not re-run the remap."""
    log = Log(ns.session(ns.db()))
    sess = log.sess
    log.sql("create table dm (id int primary key, a string, b string)")
    log.sql("insert into dm values (1, 'x', 'p'), (2, 'y', 'q')")
    reg = sess._jobs_registry()
    ns.sc.register_schema_change_job(reg, sess.catalog)
    payload = ns.sc.plan_alter(sess.catalog, sess.db,
                               ns.parse("alter table dm drop column a"))
    job = reg.create("schema_change", payload)
    claimed = reg._claim(job.job_id, reg.load(job.job_id))

    def crashing_wd(db, t, writer=None):
        raise Boom

    real_wd = ns.table.write_descriptor
    ns.table.write_descriptor = crashing_wd
    try:
        with pytest.raises(Boom):
            ns.sc.backfill(reg, claimed, sess.catalog)
    finally:
        ns.table.write_descriptor = real_wd
    assert reg.load(job.job_id).progress.get("dict_remapped") is True
    done = reg.adopt_and_resume(job.job_id)
    log.append(("done", done.state, done.progress))
    assert done.state == "succeeded"
    assert list(log.sql("select b from dm order by id")["b"]) == ["p", "q"]
    return log


def string_agg_downstream_guards(ns):
    log = Log(ns.session(ns.db()))
    log.sql("create table gg (id int primary key, g int, s string)")
    log.sql("insert into gg values (1, 1, 'a'), (2, 1, 'b'), (3, 2, 'c')")
    got = log.sql("select g, string_agg(s, ',') as x from gg group by g")
    assert sorted(got["x"]) == ["a,b", "c"]
    err = log.sql("select g, string_agg(s, ',') as x from gg group by g "
                  "order by x")
    assert isinstance(err, Exception) and "string_agg" in str(err)
    # the refusal's class and text differ (ROADMAP Queue 3): the reference
    # wraps its SortOp's ValueError in QueryError at run time, the port
    # raises a ValueError of its own while building the operator
    log[-1] = log[-1][:1] + ("refused",)
    return log


SCENARIOS = (
    add_column_with_default_backfills,
    add_column_null_default,
    drop_column,
    alter_errors,
    backfill_resumes_from_checkpoint,
    add_string_column_with_default,
    drop_resume_does_not_corrupt_surviving_string_dict,
    string_agg_downstream_guards,
)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_schema_change_equals_reference(scenario):
    jlog, tlog = scenario(J), scenario(T)
    assert list(tlog) == list(jlog)
    engines_equal(jlog.sess.db, tlog.sess.db)
    jlog.sess.close()
    tlog.sess.close()


# -- jobs: checkpointed resume, fencing, orphan adoption ---------------------


def jobs_resume_from_checkpoint(ns):
    """A job killed mid-run resumes from its persisted progress."""
    db = ns.db(256)
    reg = ns.jobs.Registry(db)
    work_log: list[int] = []
    crash_at = {"n": 3}

    def resume(registry, job):
        done = job.progress.get("done", 0)
        total = job.payload["total"]
        for i in range(done, total):
            if i == crash_at["n"]:
                crash_at["n"] = -1
                raise RuntimeError("simulated crash")
            work_log.append(i)
            job.progress["done"] = i + 1
            registry.checkpoint(job)
        return {"rows": total}

    reg.register("backfill", resume)
    job = reg.create("backfill", {"total": 6})
    assert reg.load(job.job_id).state == "pending"
    with pytest.raises(RuntimeError):
        reg.adopt_and_resume(job.job_id)
    failed = reg.load(job.job_id)
    assert failed.state == "failed" and work_log == [0, 1, 2]
    reg2 = ns.jobs.Registry(db)
    reg2.register("backfill", resume)
    j = reg2.load(job.job_id)
    j.state = "pending"  # the operator's RESUME JOB
    reg2.checkpoint(j)
    out = reg2.adopt_and_resume(job.job_id)
    assert out.state == "succeeded" and out.progress["rows"] == 6
    assert work_log == [0, 1, 2, 3, 4, 5]
    return db, [repr(failed), repr(out), work_log]


def dead_nodes_job_is_fenced_and_readopted(ns):
    db = ns.db(256)
    lv1 = ns.live.NodeLiveness(db, 1, ttl_ms=200)
    lv1.heartbeat()
    reg1 = ns.jobs.Registry(db, node_id=1, liveness=lv1)
    state = {"steps": 0}

    def slow_resume(reg, job):
        state["steps"] += 1
        if state["steps"] == 1:
            raise RuntimeError("node 1 crashed mid-job")
        job.progress["resumed_by"] = reg.node_id
        reg.checkpoint(job)
        return {"done": True}

    reg1.register("slow", slow_resume)
    job = reg1.create("slow", {})
    with pytest.raises(RuntimeError):
        reg1.adopt_and_resume(job.job_id)
    j = reg1.load(job.job_id)
    j.state = "running"  # the crash came before the failure checkpoint
    reg1.checkpoint(j)
    db.clock.advance(300)  # node 1's 200 ms ttl elapses
    lv2 = ns.live.NodeLiveness(db, 2, ttl_ms=5000)
    lv2.heartbeat()
    reg2 = ns.jobs.Registry(db, node_id=2, liveness=lv2)
    reg2.register("slow", slow_resume)
    adopted = reg2.adopt_orphans()
    assert [a.job_id for a in adopted] == [job.job_id]
    done = reg2.load(job.job_id)
    assert done.state == "succeeded" and done.claim_node == 2
    assert done.progress["resumed_by"] == 2
    stale = reg1.load(job.job_id)
    stale.claim_node, stale.claim_epoch = 1, 1
    errs = []
    for fn in (lambda: reg1.checkpoint(stale), lv1.heartbeat):
        with pytest.raises(ns.live.EpochFencedError) as e:
            fn()
        errs.append(str(e.value))
    return db, [repr(done), errs, repr(lv2._read(1))]


def claim_cas_prevents_double_adoption(ns):
    db = ns.db(256)
    lv1 = ns.live.NodeLiveness(db, 1, ttl_ms=100)
    lv1.heartbeat()
    reg1 = ns.jobs.Registry(db, node_id=1, liveness=lv1)
    runs = []

    def resume(reg, job):
        runs.append(reg.node_id)
        return {}

    reg1.register("r", resume)
    job = reg1.create("r", {})
    j = reg1.load(job.job_id)
    j.state, j.claim_node, j.claim_epoch = "running", 1, 1
    reg1.checkpoint(j)
    db.clock.advance(150)  # the claimant's record expires
    regs = []
    for nid in (2, 3):
        lv = ns.live.NodeLiveness(db, nid, ttl_ms=5000)
        lv.heartbeat()
        reg = ns.jobs.Registry(db, node_id=nid, liveness=lv)
        reg.register("r", resume)
        regs.append(reg)
    reg2, reg3 = regs
    observed2 = reg2.load(job.job_id)
    observed3 = reg3.load(job.job_id)
    won2 = reg2._claim(job.job_id, observed2)
    won3 = reg3._claim(job.job_id, observed3)
    assert won2 is not None and won2.claim_node == 2
    assert won3 is None
    reg2.adopt_orphans()
    reg3.adopt_orphans()
    assert runs == [2]
    final = reg3.load(job.job_id)
    assert final.state == "succeeded"
    return db, [repr(won2), repr(final), runs]


def stale_epoch_create_index_is_fenced(ns):
    """A CREATE INDEX job claimed by node 1 at epoch 1, whose epoch a peer
    bumps before the swap: the swap's fenced read raises
    EpochFencedError and the index never becomes visible."""
    db = ns.db()
    sess = ns.session(db)
    sess.execute("create table ix (id int primary key, v int)")
    lv1 = ns.live.NodeLiveness(db, 1, ttl_ms=100)
    lv1.heartbeat()
    reg1 = ns.jobs.Registry(db, node_id=1, liveness=lv1)
    ns.index.register_create_index_job(reg1, sess.catalog)
    payload = ns.index.plan_create_index(
        sess.catalog, db, ns.parse("create index ix_v on ix (v)"))
    job = reg1.create("create_index", payload)
    claimed = reg1._claim(job.job_id, reg1.load(job.job_id))
    assert (claimed.claim_node, claimed.claim_epoch) == (1, 1)
    db.clock.advance(200)
    ns.live.NodeLiveness(db, 2, ttl_ms=5000).increment_epoch(1)
    with pytest.raises(ns.live.EpochFencedError) as e:
        ns.index.backfill_index(reg1, claimed, sess.catalog)
    assert sess.catalog.tables["ix"].indexes == []
    sess.close()
    return db, [str(e.value), repr(reg1.load(job.job_id))]


JOB_SCENARIOS = (
    jobs_resume_from_checkpoint,
    dead_nodes_job_is_fenced_and_readopted,
    claim_cas_prevents_double_adoption,
    stale_epoch_create_index_is_fenced,
)


@pytest.mark.parametrize("scenario", JOB_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_jobs_equal_reference(scenario):
    jdb, jout = scenario(J)
    tdb, tout = scenario(T)
    assert tout == jout
    engines_equal(jdb, tdb)


def test_alter_drops_the_tables_indexes_as_the_reference_does():
    """Reference fault carried over (ROADMAP Queue 3): the swapped
    descriptor is built without the table's indexes, so ALTER TABLE
    drops every index of the table in both packages (their entries stay
    in the engine). The port keeps the reference's behaviour: the
    engines stay byte-equal."""
    logs = []
    for ns in (J, T):
        log = Log(ns.session(ns.db()))
        log.sql("create table t (id int primary key, v int)")
        log.sql("insert into t values (1, 10), (2, 20)")
        log.sql("create index t_v on t (v)")
        before = [ix.name for ix in log.sess.catalog.tables["t"].indexes]
        log.sql("alter table t add column w int default 0")
        after = [ix.name for ix in log.sess.catalog.tables["t"].indexes]
        log.sql("select id, w from t where v = 20")
        log.append((before, after))
        logs.append(log)
    jlog, tlog = logs
    assert list(tlog) == list(jlog)
    assert jlog[-1] == (["t_v"], [])
    engines_equal(jlog.sess.db, tlog.sess.db)
