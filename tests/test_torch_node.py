"""The port's node lifecycle and admin API (cockroach_tpu_torch/server/
{node,http}.py) against the reference's on the CPU: the counterparts of
tests/test_node.py's eight tests and of tests/test_server_aux.py's disk
health and request-timeout tests. Each scenario drives both packages'
Node (or their liveness and jobs pieces) over the same writes and
compares what both count alike: jobs adopted and their states, epochs
fenced, timeseries sample keys, a setting propagated through gossip,
loops stopped, and each endpoint's payload keys and values (node ids,
liveness, epochs, job types and states; the metric and setting names
that both registries hold). Torch runs on one thread."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from cockroach_tpu.kv import DB as jDB
from cockroach_tpu.kv import Clock as jClock
from cockroach_tpu.kv.jobs import Registry as jRegistry
from cockroach_tpu.kv.liveness import EpochFencedError as jFenced
from cockroach_tpu.kv.liveness import NodeLiveness as jLiveness
from cockroach_tpu.kv.liveness import StillLiveError as jStillLive
from cockroach_tpu.server.node import Node as jNode
from cockroach_tpu.storage.lsm import Engine as jEngine
from cockroach_tpu.utils import settings as jsettings
from cockroach_tpu_torch.kv import DB as tDB
from cockroach_tpu_torch.kv import Clock as tClock
from cockroach_tpu_torch.kv.jobs import Registry as tRegistry
from cockroach_tpu_torch.kv.liveness import EpochFencedError as tFenced
from cockroach_tpu_torch.kv.liveness import NodeLiveness as tLiveness
from cockroach_tpu_torch.kv.liveness import StillLiveError as tStillLive
from cockroach_tpu_torch.server.node import Node as tNode
from cockroach_tpu_torch.storage.lsm import Engine as tEngine
from cockroach_tpu_torch.utils import settings as tsettings


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


PKGS = {
    "jax": dict(Node=jNode, Engine=jEngine, DB=jDB, Clock=jClock,
                Registry=jRegistry, Liveness=jLiveness, Fenced=jFenced,
                StillLive=jStillLive, settings=jsettings, kw={}),
    "torch": dict(Node=tNode, Engine=tEngine, DB=tDB, Clock=tClock,
                  Registry=tRegistry, Liveness=tLiveness, Fenced=tFenced,
                  StillLive=tStillLive, settings=tsettings,
                  kw={"device": "cpu"}),
}


def _node(pkg, **kw):
    P = PKGS[pkg]
    return P["Node"](**kw, **P["kw"])


def _engine(pkg, **kw):
    P = PKGS[pkg]
    return P["Engine"](**kw, **P["kw"])


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read()


def _node_threads(node_id: int) -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.endswith(f"-n{node_id}") and t.is_alive()]


def test_engine_writes_pace_under_l0_overload():
    """Many small flushes pile up runs; pacing engages and delays a write,
    and switching it off removes the delay: equal run counts and
    throttled writes in both packages."""
    got = {}
    for pkg in PKGS:
        S = PKGS[pkg]["settings"]
        eng = _engine(pkg, key_width=16, val_width=8, memtable_size=4,
                      l0_trigger=40, compact_width=4)
        eng.governor.healthy_runs = 8
        S.set("admission.io_pacing.enabled", True)
        try:
            for i in range(120):
                eng.put(b"k%06d" % i, b"v", ts=i + 1)
            runs = len(eng.runs)
            before = eng.governor.throttled
            t0 = time.time()
            eng.put(b"zz%04d" % 0, b"v", ts=1000)
            paced = time.time() - t0
            assert paced >= eng.governor.delay_per_run_s
            S.set("admission.io_pacing.enabled", False)
            mid = eng.governor.throttled
            eng.put(b"zz%04d" % 1, b"v", ts=1001)
            got[pkg] = (runs, mid - before, eng.governor.throttled - mid)
        finally:
            S.reset("admission.io_pacing.enabled")
    assert got["torch"] == got["jax"]
    assert got["torch"][0] > 8 and got["torch"][1] == 1


def test_node_metrics_ticker_feeds_tsdb():
    """The metrics ticker records samples: at least two of
    storage_writes, monotone in time, under the same key layout."""
    for pkg in PKGS:
        node = _node(pkg, node_id=1, metrics_interval_s=0.05,
                     heartbeat_interval_s=0.05, ttl_ms=30000)
        node.start(gossip_port=None)
        try:
            deadline = time.time() + 10
            series = []
            while time.time() < deadline:
                series = node.tsdb.query("storage_writes")
                if len(series) >= 2:
                    break
                time.sleep(0.05)
            assert len(series) >= 2, f"{pkg}: ticker produced no samples"
            walls = [w for w, _ in series]
            assert walls == sorted(walls)
            keys = [k for k, _ in node.db.scan(b"\x01tsstorage_writes|",
                                               b"\x01tsstorage_writes}")]
            assert len(keys) >= 2
            assert all(len(k) == len(b"\x01tsstorage_writes|") + 13
                       for k in keys)
        finally:
            node.stop()
        assert _node_threads(1) == []


def test_dead_nodes_job_is_fenced_and_readopted():
    """Node 1 claims a job and dies; node 2 fences its epoch, adopts and
    finishes the job; node 1's late checkpoint and heartbeat are fenced.
    The same adoptions, states and claimants in both packages."""
    got = {}
    for pkg, P in PKGS.items():
        db = P["DB"](_engine(pkg, val_width=256), P["Clock"]())
        lv1 = P["Liveness"](db, 1, ttl_ms=200)
        lv1.heartbeat()
        reg1 = P["Registry"](db, node_id=1, liveness=lv1)
        state = {"steps": 0}

        def slow_resume(reg, job, state=state):
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
        j.state = "running"
        reg1.checkpoint(j)
        time.sleep(0.3)
        lv2 = P["Liveness"](db, 2, ttl_ms=5000)
        lv2.heartbeat()
        reg2 = P["Registry"](db, node_id=2, liveness=lv2)
        reg2.register("slow", slow_resume)
        adopted = [a.job_id for a in reg2.adopt_orphans()]
        done = reg2.load(job.job_id)
        stale = reg1.load(job.job_id)
        stale.claim_node, stale.claim_epoch = 1, 1
        with pytest.raises(P["Fenced"]):
            reg1.checkpoint(stale)
        with pytest.raises(P["Fenced"]):
            lv1.heartbeat()
        got[pkg] = (adopted == [job.job_id], done.state, done.claim_node,
                    done.progress["resumed_by"],
                    lv2.livenesses()[0].epoch)
    assert got["torch"] == got["jax"] == (True, "succeeded", 2, 2, 2)


def test_gossip_propagates_cluster_setting_between_nodes():
    """A SET on node 1 publishes into gossip and lands in node 2's
    infostore and settings: 19 in both packages."""
    name = "sql.distsql.dense_lut_bits"
    for pkg, P in PKGS.items():
        S = P["settings"]
        S.reset(name)
        n1 = _node(pkg, node_id=1, heartbeat_interval_s=0.05, ttl_ms=30000)
        n1.start(gossip_port=0)
        n2 = _node(pkg, node_id=2, heartbeat_interval_s=0.05, ttl_ms=30000,
                   gossip_peers=[n1.gossip_addr()])
        n2.start(gossip_port=0)
        try:
            S.set(name, 19)
            deadline = time.time() + 10
            while time.time() < deadline:
                if n2.gossip.get_info("setting/" + name) == 19:
                    break
                time.sleep(0.05)
            assert n2.gossip.get_info("setting/" + name) == 19, pkg
            assert S.get(name) == 19
        finally:
            n1.stop()
            n2.stop()
            S.reset(name)
        assert _node_threads(1) == [] and _node_threads(2) == []


def test_claim_cas_prevents_double_adoption():
    """Two nodes race the claim of an orphan: exactly one wins, and the
    job runs once, on node 2, in both packages."""
    got = {}
    for pkg, P in PKGS.items():
        db = P["DB"](_engine(pkg, val_width=256), P["Clock"]())
        lv1 = P["Liveness"](db, 1, ttl_ms=100)
        lv1.heartbeat()
        reg1 = P["Registry"](db, node_id=1, liveness=lv1)
        runs = []

        def resume(reg, job, runs=runs):
            runs.append(reg.node_id)
            return {}

        reg1.register("r", resume)
        job = reg1.create("r", {})
        j = reg1.load(job.job_id)
        j.state, j.claim_node, j.claim_epoch = "running", 1, 1
        reg1.checkpoint(j)
        time.sleep(0.15)
        regs = []
        for nid in (2, 3):
            lv = P["Liveness"](db, nid, ttl_ms=5000)
            lv.heartbeat()
            reg = P["Registry"](db, node_id=nid, liveness=lv)
            reg.register("r", resume)
            regs.append(reg)
        obs = [r.load(job.job_id) for r in regs]
        won = [r._claim(job.job_id, o) for r, o in zip(regs, obs)]
        for r in regs:
            r.adopt_orphans()
        got[pkg] = (won[0].claim_node, won[1], runs,
                    regs[1].load(job.job_id).state)
    assert got["torch"] == got["jax"] == (2, None, [2], "succeeded")


def test_fenced_node_stops_all_loops():
    """A peer fences node 1's epoch: its next heartbeat stops the whole
    node (in both packages), and stop() leaves no node thread. Node 1's
    heartbeats are blackholed (``liveness.heartbeat.n1``) until its
    record lapses and the peer fences it, then let through."""
    from cockroach_tpu.utils import faults as jfaults
    from cockroach_tpu_torch.utils import faults as tfaults

    for pkg, P in PKGS.items():
        faults = jfaults if pkg == "jax" else tfaults
        db = P["DB"](_engine(pkg, key_width=64, val_width=256), P["Clock"]())
        n1 = _node(pkg, node_id=1, db=db, heartbeat_interval_s=0.05,
                   ttl_ms=150)
        n1.start(gossip_port=None)
        try:
            lv9 = P["Liveness"](db, 9, ttl_ms=5000)
            lv9.heartbeat()
            faults.arm(9, {"liveness.heartbeat.n1":
                           faults.FaultSpec(kind="error")})
            try:
                deadline = time.time() + 10
                while time.time() < deadline:
                    try:
                        lv9.increment_epoch(1)
                        break
                    except P["StillLive"]:
                        time.sleep(0.05)
            finally:
                faults.disarm()
            deadline = time.time() + 10
            while time.time() < deadline and not n1._stop.is_set():
                time.sleep(0.05)
            assert n1._stop.is_set(), f"{pkg}: fenced node kept running"
        finally:
            n1.stop()
        assert _node_threads(1) == []


def _endpoints(pkg) -> dict:
    """Every admin endpoint's payload from a running node (node 7)."""
    node = _node(pkg, node_id=7, metrics_interval_s=0.05,
                 heartbeat_interval_s=0.1, ttl_ms=30000)
    node.start(gossip_port=None, http_port=0)
    out = {}
    try:
        port = node.admin.port
        node.jobs.create("backup", {"dest": "/tmp/x"})
        deadline = time.time() + 10
        while time.time() < deadline:
            pts = json.loads(_get(port, "/ts/query?name=storage_writes")[1])
            if pts["datapoints"]:
                break
            time.sleep(0.05)
        out["ts"] = pts
        for path in ("/health", "/_status/nodes", "/_status/jobs",
                     "/_status/settings", "/_status/statements",
                     "/hot_ranges", "/_status/contention", "/_status/spans",
                     "/_status/diagnostics", "/_status/load",
                     "/_status/changefeeds"):
            st, body = _get(port, path)
            assert st == 200, (pkg, path)
            out[path] = json.loads(body)
        out["vars"] = _get(port, "/_status/vars")[1].decode()
        out["console"] = _get(port, "/")[1]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/no/such/path")
        out["404"] = e.value.code
    finally:
        node.stop()
    return out


def test_admin_http_endpoints():
    """Every endpoint answers over real HTTP in both packages with the
    same payload keys, and the same values where both count alike."""
    got = {pkg: _endpoints(pkg) for pkg in PKGS}
    j, t = got["jax"], got["torch"]
    assert t["/health"] == j["/health"] == {"nodeId": 7, "isLive": True}
    for rec_t, rec_j in zip(t["/_status/nodes"]["nodes"],
                            j["/_status/nodes"]["nodes"]):
        assert sorted(rec_t) == sorted(rec_j)
        assert (rec_t["nodeId"], rec_t["epoch"], rec_t["isLive"]) == \
            (rec_j["nodeId"], rec_j["epoch"], rec_j["isLive"]) == (7, 1, True)
    strip = [{k: v for k, v in r.items() if k != "id"}
             for r in t["/_status/jobs"]["jobs"]]
    assert strip == [{k: v for k, v in r.items() if k != "id"}
                     for r in j["/_status/jobs"]["jobs"]]
    assert any(r["type"] == "backup" for r in strip)
    ts, js = t["/_status/settings"]["settings"], \
        j["/_status/settings"]["settings"]
    shared = set(ts) & set(js)
    assert "sql.distsql.dense_agg_states" in shared and len(shared) > 40
    assert {n: ts[n] for n in shared} == {n: js[n] for n in shared}
    for path in ("/_status/statements", "/hot_ranges", "/_status/contention",
                 "/_status/spans", "/_status/diagnostics",
                 "/_status/changefeeds"):
        assert sorted(t[path]) == sorted(j[path]), path
    assert t["/hot_ranges"] == j["/hot_ranges"] == {"hotRanges": []}
    assert sorted(t["/_status/load"]) == sorted(j["/_status/load"])
    for part in ("memory", "admission", "activity"):
        assert sorted(t["/_status/load"][part]) == \
            sorted(j["/_status/load"][part])
    assert t["/_status/load"]["nodeId"] == 7
    assert t["ts"]["name"] == j["ts"]["name"] == "storage_writes"
    assert t["ts"]["datapoints"] and all(len(p) == 2
                                         for p in t["ts"]["datapoints"])
    assert "# TYPE storage_writes counter" in t["vars"]
    types = {}
    for pkg in got:
        types[pkg] = dict(ln.split()[2:4] for ln in got[pkg]["vars"]
                          .splitlines() if ln.startswith("# TYPE"))
    shared = set(types["torch"]) & set(types["jax"])
    assert len(shared) > 30 and "storage_writes" in shared
    assert {n: types["torch"][n] for n in shared} == \
        {n: types["jax"][n] for n in shared}
    assert t["console"] == j["console"]
    assert t["404"] == j["404"] == 404


def test_console_page_served():
    """The console page at / names itself and reads /_status/vars."""
    node = _node("torch", node_id=2, heartbeat_interval_s=0.1, ttl_ms=30000)
    node.start(gossip_port=None, http_port=0)
    try:
        st, body = _get(node.admin.port, "/")
        assert st == 200
        assert b"cockroach_tpu node console" in body
        assert b"/_status/vars" in body
    finally:
        node.stop()


def test_health_endpoint_reports_disk(tmp_path):
    """A WAL-backed node gets a disk monitor; /health reports its slow
    flag, false, then true after slow observations: in both packages."""
    for pkg in PKGS:
        eng = _engine(pkg, key_width=64, val_width=128,
                      wal_path=str(tmp_path / f"{pkg}.wal"))
        node = _node(pkg, node_id=3, engine=eng, heartbeat_interval_s=0.1,
                     ttl_ms=30000)
        node.start(gossip_port=None, http_port=0)
        try:
            assert node.disk is not None
            h = json.loads(_get(node.admin.port, "/health")[1])
            assert h["diskSlow"] is False and "diskWriteP99Ms" in h
            thr = PKGS[pkg]["settings"].get("storage.disk.slow_threshold_ms")
            for _ in range(300):
                node.disk.observe(thr / 1e3 * 5)
            h = json.loads(_get(node.admin.port, "/health")[1])
            assert h["diskSlow"] is True, pkg
        finally:
            node.stop()


def test_http_handler_carries_request_timeout(tmp_path):
    """Admin handler threads bound their request reads, and a silent
    client does not block a real request: in both packages."""
    timeouts = {}
    for pkg in PKGS:
        eng = _engine(pkg, key_width=64, val_width=128,
                      wal_path=str(tmp_path / f"t{pkg}.wal"))
        node = _node(pkg, node_id=4, engine=eng, heartbeat_interval_s=0.1,
                     ttl_ms=30000)
        node.start(gossip_port=None, http_port=0)
        try:
            timeouts[pkg] = node.admin._httpd.RequestHandlerClass.timeout
            silent = socket.create_connection(("127.0.0.1", node.admin.port))
            try:
                h = json.loads(_get(node.admin.port, "/health")[1])
                assert "diskSlow" in h
            finally:
                silent.close()
        finally:
            node.stop()
    assert timeouts["torch"] == timeouts["jax"]
    assert 0 < timeouts["torch"] <= 60


def test_node_defaults_to_the_card():
    """``device`` defaults to "cuda": without a card the node raises; a
    store on another device is refused."""
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="store on cpu"):
            tNode(engine=tEngine(key_width=64, val_width=128, device="cpu"))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tNode()
