"""HTTP admin API — the pkg/server status/admin endpoint reduction; the
port of ``cockroach_tpu.server.http``.

Reference: pkg/server serves the db-console's data plane over HTTP —
`/_status/vars` (prometheus text exposition), `/health`, `/_status/nodes`
(node liveness + metadata, api_v2*.go), `/_status/jobs`, and timeseries
queries (pkg/ts/server.go). The TypeScript console itself is out of scope
(SURVEY §2.7: "keep HTTP JSON APIs first"); this module is those APIs over
the Node's subsystems, so an operator can curl the same surfaces.

Endpoints (all GET):
  /health             -> {"nodeId": N, "isLive": bool}  (healthz alias too)
  /_status/vars       -> prometheus text (utils/metric Registry.scrape)
  /_status/nodes      -> {"nodes": [liveness records + epoch + liveness]}
  /_status/jobs       -> {"jobs": [job records]}
  /_status/settings   -> {"settings": {name: value}}
  /ts/query?name=&start=&end= -> {"datapoints": [[ts_ms, value], ...]}

Also /_status/statements, /hot_ranges, /_status/contention,
/_status/diagnostics[?id=], /_status/spans, /_status/load (its
``device`` entry is the card's allocator, ``flow/memory.
device_memory_stats``), /_status/changefeeds and the console page at /.
Every payload reads the port's own registries.

Built on http.server (stdlib) with a daemon thread per server; the Node
owns start/stop. One handler class per Node instance via a closure so two
nodes in one process (tests) never share state.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..utils import log, metric, settings
from ..utils.errors import retry_past_intents as _status_read

# minimal db-console (the TypeScript console stays out of scope; this
# single self-contained page renders the SAME status APIs an operator
# would curl, so the HTTP surface is demonstrably sufficient for a UI)
_CONSOLE_HTML = b"""<!doctype html><html><head>
<meta charset="utf-8"><title>cockroach_tpu console</title>
<style>
 body{font:14px ui-monospace,monospace;margin:2em;background:#fafafa}
 h1{font-size:18px} h2{font-size:15px;margin-top:1.4em}
 table{border-collapse:collapse} td,th{border:1px solid #ccc;
 padding:3px 9px;text-align:left} .ok{color:#06792e}.bad{color:#b00020}
 pre{background:#f0f0f0;padding:8px;max-height:300px;overflow:auto}
</style></head><body>
<h1>cockroach_tpu node console</h1>
<div id="health"></div>
<h2>nodes</h2><table id="nodes"></table>
<h2>jobs</h2><table id="jobs"></table>
<h2>statements</h2><table id="stmts"></table>
<h2>contention</h2><table id="cont"></table>
<h2>memory / load</h2><table id="load"></table>
<h2>metrics (/_status/vars)</h2><pre id="vars"></pre>
<script>
async function j(p){return (await fetch(p)).json()}
function mvar(text,name){
 const m=text.match(new RegExp('^'+name+' ([0-9.eE+-]+)$','m'));
 return m?Number(m[1]):0;
}
function mib(n){return (n/1048576).toFixed(1)+' MiB'}
async function refresh(){
 const h=await j('/health');
 document.getElementById('health').innerHTML=
  `node ${h.nodeId}: <b class="${h.isLive?'ok':'bad'}">`+
  `${h.isLive?'LIVE':'NOT LIVE'}</b>`+
  (h.diskSlow!==undefined?` | disk p99 ${h.diskWriteP99Ms}ms`+
   (h.diskSlow?' <b class="bad">SLOW</b>':''):'');
 const ns=(await j('/_status/nodes')).nodes;
 document.getElementById('nodes').innerHTML=
  '<tr><th>id</th><th>epoch</th><th>live</th></tr>'+ns.map(n=>
  `<tr><td>${n.nodeId}</td><td>${n.epoch}</td><td>${n.isLive}</td></tr>`
  ).join('');
 const js=(await j('/_status/jobs')).jobs;
 document.getElementById('jobs').innerHTML=
  '<tr><th>id</th><th>type</th><th>state</th><th>node</th></tr>'+
  js.map(x=>`<tr><td>${x.id}</td><td>${x.type}</td>`+
  `<td>${x.state}</td><td>${x.claimNode}</td></tr>`).join('');
 const ss=(await j('/_status/statements')).statements.slice(0,15);
 document.getElementById('stmts').innerHTML=
  '<tr><th>fingerprint</th><th>count</th><th>mean ms</th>'+
  '<th>rows</th><th>errors</th></tr>'+ss.map(s=>
  `<tr><td>${s.fingerprint.slice(0,70)}</td><td>${s.count}</td>`+
  `<td>${s.meanMs}</td><td>${s.rows}</td><td>${s.errors}</td></tr>`
  ).join('');
 const ce=(await j('/_status/contention')).events.slice(0,10);
 document.getElementById('cont').innerHTML=
  '<tr><th>key</th><th>count</th><th>waiters</th></tr>'+ce.map(e=>
  `<tr><td>${e.key}</td><td>${e.count}</td>`+
  `<td>${e.numWaiters}</td></tr>`).join('');
 const vt=await (await fetch('/_status/vars')).text();
 document.getElementById('load').innerHTML=
  '<tr><th>sql mem current</th><th>sql mem max</th>'+
  '<th>admission slots in use</th><th>queue depth</th></tr>'+
  `<tr><td>${mib(mvar(vt,'sql_mem_current'))}</td>`+
  `<td>${mib(mvar(vt,'sql_mem_max'))}</td>`+
  `<td>${mvar(vt,'admission_sql_slots_in_use')}`+
  ` / ${mvar(vt,'admission_sql_slots')}</td>`+
  `<td>${mvar(vt,'admission_sql_queue_depth')}</td></tr>`;
 document.getElementById('vars').textContent=vt;
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


def load_payload(node=None) -> dict:
    """The /_status/load body: the node's resource plane in one JSON —
    memory-monitor tree, physical device stats, admission queue state and
    live session/query counts. Module-level (not an AdminServer method) so
    debug zip can capture it without a running server."""
    from ..flow import memory
    from ..sql import activity
    from ..utils import admission

    q = admission.sql_queue()
    out = {
        "memory": {
            "currentBytes": memory.ROOT.used,
            "peakBytes": memory.ROOT.high_water,
            "rootBudgetBytes": memory.root_budget(),
            "pressure": round(memory.mem_pressure(), 4),
            "queryLeaks": memory.drain_failure_count(),
            "monitors": memory.monitor_rows(),
        },
        "device": memory.device_memory_stats(),
        "admission": {
            "slots": q.slots,
            "slotsInUse": q.in_use,
            "queueDepth": q.queue_depth,
            "maxQueueDepth": q.max_queue_depth,
            "admitted": q.admitted,
            "waited": q.waited,
            "timeouts": q.timeouts,
            "rejected": q.rejected,
            "rejectionsByReason": dict(q.rejections_by_reason),
            "laneQueueDepth": q.lane_depths(),
            "shedFloor": admission.shed_floor(),
            "tenants": q.tenant_rows(),
        },
        "activity": {
            "sessions": len(activity.sessions()),
            "activeQueries": len(activity.queries()),
        },
    }
    if node is not None:
        out["nodeId"] = node.node_id
    return out


class AdminServer:
    """HTTP admin endpoint bound to one Node. serve_background() returns
    after bind so the caller knows the port; close() joins the thread."""

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0):
        self.node = node
        self.host = host
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- endpoint payloads (plain methods: unit-testable without sockets) ----

    def health(self) -> dict:
        n = self.node
        try:
            live = n.liveness.is_live(n.node_id)
        # crlint: allow-broad-except(liveness probe failure IS the not-live answer)
        except Exception:  # noqa: BLE001
            live = False
        out = {"nodeId": n.node_id, "isLive": bool(live)}
        disk = getattr(n, "disk", None)
        if disk is not None:
            out["diskSlow"] = disk.is_slow()
            out["diskWriteP99Ms"] = round(disk.p99_ms(), 2)
        return out

    def nodes(self) -> dict:
        now = self.node.db.clock.now()
        out = []
        # liveness computed from the records just read — no per-node
        # re-read (each would retake the engine mutex)
        for rec in self.node.liveness.livenesses():
            out.append({
                "nodeId": rec.node_id,
                "epoch": rec.epoch,
                "expiration": rec.expiration,
                "isLive": rec.live_at(now),
            })
        return {"nodes": out}

    def jobs(self) -> dict:
        out = []
        for j in _status_read(self.node.jobs.jobs):
            out.append({
                "id": j.job_id,
                "type": j.job_type,
                "state": j.state,
                "claimNode": j.claim_node,
                "claimEpoch": j.claim_epoch,
            })
        return {"jobs": out}

    def statements(self) -> dict:
        from ..sql import sqlstats

        return {"statements": sqlstats.DEFAULT.rows_payload()}

    def vars(self) -> str:
        """Prometheus text exposition (/_status/vars body)."""
        return metric.DEFAULT.scrape()

    def contention(self) -> dict:
        from ..kv.contention import DEFAULT as _cont

        return {"events": _cont.rows_payload()}

    def diagnostics(self) -> dict:
        """Statement diagnostics ring listing (newest first)."""
        from ..sql import diagnostics as diag

        return {"bundles": diag.bundles()}

    def diagnostics_bundle(self, bundle_id: int) -> dict | None:
        from ..sql import diagnostics as diag

        return diag.get(bundle_id)

    def spans(self) -> dict:
        """In-flight trace spans (crdb_internal.node_inflight_trace_spans
        over HTTP): everything started but not yet finished, oldest first."""
        from ..utils import tracing

        return {"spans": [
            {"traceId": s.trace_id, "spanId": s.span_id,
             "parentSpanId": s.parent_id, "operation": s.name,
             "startWallMs": int(s.start_wall * 1e3)}
            for s in tracing.inflight()
        ]}

    def settings_payload(self) -> dict:
        return {"settings": {
            name: s.get() for name, s in settings.all_settings().items()
        }}

    def hot_ranges(self) -> dict:
        """Range lifecycle report (the /_status/hotranges role): every
        range with decayed QPS, write-bytes rate, authoritative size and
        leaseholder, hottest first. Without a running RangeLifecycle the
        payload degrades to the bare descriptor table."""
        ranger = getattr(self.node, "ranger", None)
        if ranger is not None:
            return ranger.hot_ranges()
        eng = self.node.db.engine
        meta = getattr(eng, "meta", None)
        if meta is None:
            return {"hotRanges": []}
        return {"hotRanges": [
            {"rangeId": d.range_id,
             "startKey": d.start_key.decode(errors="replace"),
             "endKey": (d.end_key.decode(errors="replace")
                        if d.end_key is not None else None),
             "storeId": d.store_id, "qps": 0.0, "writeBytesRate": 0.0,
             "sizeBytes": None, "leaseholder": None}
            for d in meta.snapshot()
        ]}

    def load(self) -> dict:
        """Resource/serving-load snapshot (/_status/load)."""
        return load_payload(self.node)

    def changefeeds(self) -> dict:
        """Fan-out plane snapshot (/_status/changefeeds): one row per
        rangefeed subscriber — span, frontier, buffered bytes, ladder
        counters — plus the node-wide changefeed staging account."""
        from ..flow import memory as flowmem
        from ..kv import fanout

        mon = flowmem.staging_monitor("changefeed")
        return {
            "subscribers": fanout.subscriber_rows(),
            "buffer_bytes": int(mon.used),
            "buffer_high_water": int(mon.high_water),
        }

    def ts_query(self, name: str, start_ms: int, end_ms: int) -> dict:
        pts = self.node.tsdb.query(name, start_ms=start_ms, end_ms=end_ms)
        return {"name": name,
                "datapoints": [[int(t), float(v)] for t, v in pts]}

    # -- plumbing ------------------------------------------------------------

    def _make_handler(self):
        admin = self

        class Handler(BaseHTTPRequestHandler):
            # StreamRequestHandler.setup() applies this as the socket
            # timeout for every request read: a client that connects
            # and never sends a request line (or stalls mid-headers)
            # releases its handler thread instead of parking it in
            # recv forever. BaseHTTPRequestHandler maps the timeout to
            # close_connection, so the slot is reclaimed cleanly.
            timeout = 30.0

            # quiet: requests land in the structured log, not stderr
            def log_message(self, fmt, *args):  # noqa: N802
                log.debug(log.OPS, "http " + fmt % args)

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code: int = 200) -> None:
                self._reply(code, json.dumps(obj).encode(),
                            "application/json")

            def do_GET(self):  # noqa: N802
                try:
                    u = urlparse(self.path)
                    if u.path in ("/", "/index.html", "/_status/ui"):
                        self._reply(200, _CONSOLE_HTML,
                                    "text/html; charset=utf-8")
                    elif u.path in ("/health", "/healthz"):
                        self._json(admin.health())
                    elif u.path == "/_status/vars":
                        self._reply(200, admin.vars().encode(),
                                    "text/plain; version=0.0.4")
                    elif u.path == "/_status/nodes":
                        self._json(admin.nodes())
                    elif u.path == "/_status/jobs":
                        self._json(admin.jobs())
                    elif u.path == "/_status/settings":
                        self._json(admin.settings_payload())
                    elif u.path == "/_status/statements":
                        self._json(admin.statements())
                    elif u.path in ("/hot_ranges", "/_status/hot_ranges"):
                        self._json(admin.hot_ranges())
                    elif u.path == "/_status/contention":
                        self._json(admin.contention())
                    elif u.path == "/_status/diagnostics":
                        q = parse_qs(u.query)
                        bid = (q.get("id") or [""])[0]
                        if bid:
                            full = admin.diagnostics_bundle(int(bid))
                            if full is None:
                                self._json({"error": f"no bundle {bid}"},
                                           404)
                            else:
                                self._json(full)
                        else:
                            self._json(admin.diagnostics())
                    elif u.path == "/_status/spans":
                        self._json(admin.spans())
                    elif u.path == "/_status/load":
                        self._json(admin.load())
                    elif u.path == "/_status/changefeeds":
                        self._json(admin.changefeeds())
                    elif u.path == "/ts/query":
                        q = parse_qs(u.query)
                        name = (q.get("name") or [""])[0]
                        if not name:
                            self._json({"error": "name required"}, 400)
                            return
                        start = int((q.get("start") or ["0"])[0])
                        end = int((q.get("end") or [str(1 << 62)])[0])
                        self._json(admin.ts_query(name, start, end))
                    else:
                        self._json({"error": f"unknown path {u.path}"}, 404)
                except BrokenPipeError:
                    pass  # client went away mid-reply
                # crlint: allow-broad-except(one bad request never kills serving; error is reported to the client)
                except Exception as e:  # noqa: BLE001
                    try:
                        self._json({"error": f"{type(e).__name__}: {e}"}, 500)
                    except OSError:
                        pass  # client also gone mid-error-reply

        return Handler

    def serve_background(self) -> "AdminServer":
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), self._make_handler()
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"admin-http-n{self.node.node_id}", daemon=True,
        )
        self._thread.start()
        log.info(log.OPS, "admin http serving", port=self.port)
        return self

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
