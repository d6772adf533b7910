"""TPC-H over the MVCC store: the eight tables bulk-loaded into one engine
through the IMPORT path, the queries read through ``KVTable.device_batch``,
and the refresh functions RF1 and RF2 (TPC-H specification §2.5) applied
in kv transactions.

    python3 -m cockroach_tpu_torch.bench.tpch_kv [--sf 1.0] [--runs 5]

Benchmark glue only; every engine feature it drives is the KV layer's:

- ``load_tpch_kv``: one ``key_width=16`` engine on the device; each table
  through ``create_kv_table`` and ``KVTable.bulk_load`` (dictionaries,
  encoding, the RunBuilder), then a full compaction. ``KVTable`` keys by
  one INT64 column, so lineitem gets ``l_key = l_orderkey * 8 +
  l_linenumber`` and partsupp ``ps_key = ps_partkey * 2^32 +
  ps_suppkey``; the queries never read them.
- ``gen_refresh``: RF1's SF x 1,500 new orders (1-7 lineitems each, keys
  above the loaded ones, drawn as the generator draws them, strings from
  the loaded dictionaries) and RF2's SF x 1,500 loaded orders to delete.
- ``apply_rf1``/``apply_rf2``: ``insert_rows`` and ``delete_pk`` inside
  ``DB.txn`` (``txns`` transactions each); ``refreshed_catalog`` is the
  host catalog of the data as it then stands, which the numpy oracle
  (``bench/tpch_oracle.py``) reads.
- ``index_engine``: a second engine (``key_width=24``: index entries are
  21 bytes) holding orders with a secondary index on ``o_custkey``, made
  through the CREATE INDEX job before the load; ``custkey_lookup`` is the
  plan of one lookup.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..catalog import Catalog, Table
from ..coldata.types import INT64, Schema
from ..device import resolve_device
from ..kv import DB, Clock
from ..kv import index as ixm
from ..kv.jobs import Registry
from ..kv.table import KVTable, create_kv_table
from ..ops import expr as ex
from ..sql.rel import Rel
from ..storage import rowcodec
from ..storage.lsm import Engine
from ..utils import metric
from .tpch import CURRENT_DATE, END_DATE, START_DATE

TABLES = ("region", "nation", "supplier", "part", "partsupp", "customer",
          "orders", "lineitem")
PRIMARY = {"region": "r_regionkey", "nation": "n_nationkey",
           "supplier": "s_suppkey", "part": "p_partkey",
           "customer": "c_custkey", "orders": "o_orderkey",
           "partsupp": "ps_key", "lineitem": "l_key"}


def lineitem_key(orderkey, linenumber):
    return np.asarray(orderkey, np.int64) * 8 + np.asarray(linenumber,
                                                          np.int64)


def _key_column(name: str, cols: dict) -> np.ndarray | None:
    if name == "lineitem":
        return lineitem_key(cols["l_orderkey"], cols["l_linenumber"])
    if name == "partsupp":
        return (np.asarray(cols["ps_partkey"], np.int64) << 32) | np.asarray(
            cols["ps_suppkey"], np.int64)
    return None


def kv_schema(t: Table) -> Schema:
    """A host table's schema, plus its single-column key where the TPC-H
    key has two columns."""
    if PRIMARY[t.name] in t.schema.names:
        return t.schema
    return Schema(t.schema.names + (PRIMARY[t.name],),
                  t.schema.types + (INT64,))


def host_columns(t: Table) -> dict[str, np.ndarray]:
    """A host table's columns as bulk_load takes them: STRING columns as
    their values, the single-column key appended."""
    cols = {}
    for name in t.schema.names:
        a = np.asarray(t.columns[name])
        d = t.dictionaries.get(name)
        cols[name] = d.values[a] if d is not None else a
    key = _key_column(t.name, t.columns)
    if key is not None:
        cols[PRIMARY[t.name]] = key
    return cols


def engine_bytes(eng: Engine) -> int:
    """Device bytes of the engine's runs."""
    return sum(r.nbytes() for r in eng.runs)


def load_tpch_kv(host: Catalog, device="cuda", memtable_size: int = 1 << 20,
                 clock=None, stores: int = 1) -> tuple[Catalog, DB, dict]:
    """Bulk-load every table of `host` into one engine on `device`: a
    Catalog of KVTables, its DB (on `clock`, default a wall clock), and
    the load's figures (rows, seconds, rows/s, the seconds of its parts,
    runs, compactions, device bytes).

    With ``stores`` > 1 the DB is a DistSender over that many stores
    (kv/dist.py, one range on store 1 until the caller splits and moves
    it); each chunk lands through ``DistSender.ingest``, since the run
    builder's presorted runs are single-engine (the reference's
    DistSender takes no ``presorted`` either)."""
    import contextlib

    from ..utils import settings

    dev = resolve_device(device)
    width = max(rowcodec.value_width(kv_schema(host.get(n))) for n in TABLES)
    if stores > 1:
        from ..kv.dist import make_cluster

        eng = make_cluster(stores, device=dev, key_width=16,
                           val_width=width, memtable_size=memtable_size)
        scope = settings.scoped({"storage.bulk_ingest.enabled": False})
    else:
        eng = Engine(key_width=16, val_width=width,
                     memtable_size=memtable_size, device=dev)
        scope = contextlib.nullcontext()
    engines = ([s.engine for s in eng.stores.values()] if stores > 1
               else [eng])
    db = DB(eng, clock or Clock())
    cat = Catalog(dev)
    parts: dict[str, float] = {}
    rows = 0
    t0 = time.perf_counter()
    parts["compaction"] = 0.0
    with scope:
        for name in TABLES:
            ht = host.get(name)
            t = create_kv_table(cat, db, name, kv_schema(ht), PRIMARY[name])
            rows += t.bulk_load(host_columns(ht), timings=parts)
            # each table's runs (and the memtable of dictionary entries)
            # merge into one before the next table's dictionary puts,
            # which the IOGovernor would otherwise pace for every run over
            # its healthy count
            _sync(dev)
            t1 = time.perf_counter()
            eng.compact(bottom=True)
            _sync(dev)
            parts["compaction"] += time.perf_counter() - t1
    secs = time.perf_counter() - t0
    return cat, db, {
        "rows": rows, "load_s": secs, "rows_per_s": rows / secs,
        "parts_s": parts, "runs": sum(len(e.runs) for e in engines),
        "compactions": sum(e.stats.compactions for e in engines),
        "device_bytes": sum(engine_bytes(e) for e in engines),
        "val_width": width}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# refresh functions


def _pick(rng, d, n: int) -> np.ndarray:
    """n values drawn uniformly from a loaded dictionary."""
    return d.values[rng.integers(0, len(d.values), n)]


def gen_refresh(host: Catalog, sf: float, seed: int = 1) -> dict:
    """RF1's new orders and lineitems ({column: values}, STRING columns as
    values) and RF2's orderkeys to delete, SF x 1,500 of each."""
    rng = np.random.default_rng(seed)
    n = max(1, round(1500 * sf))
    orders, li = host.get("orders"), host.get("lineitem")
    part, cust = host.get("part"), host.get("customer")
    okey = np.asarray(orders.columns["o_orderkey"])
    new_keys = int(okey.max()) + 1 + np.arange(n, dtype=np.int64)
    custkey = np.asarray(cust.columns["c_custkey"])
    eligible = custkey[custkey % 3 != 0]
    o_date = rng.integers(START_DATE, END_DATE - 121, n).astype(np.int64)
    n_lines = rng.integers(1, 8, n)
    m = int(n_lines.sum())
    l_okey = np.repeat(new_keys, n_lines)
    l_line = (np.arange(m) - np.repeat(np.cumsum(n_lines) - n_lines,
                                       n_lines) + 1).astype(np.int64)
    n_part = len(part.columns["p_partkey"])
    n_supp = len(host.get("supplier").columns["s_suppkey"])
    stride = max(1, n_supp // 4)
    l_part = rng.integers(1, n_part + 1, m, dtype=np.int64)
    l_supp = (l_part + rng.integers(0, 4, m) * stride) % n_supp + 1
    qty = rng.integers(1, 51, m, dtype=np.int64) * 100
    retail = np.asarray(part.columns["p_retailprice"], np.int64)
    price = (qty // 100) * retail[l_part - 1]
    disc = rng.integers(0, 11, m, dtype=np.int64)
    tax = rng.integers(0, 9, m, dtype=np.int64)
    od = np.repeat(o_date, n_lines)
    ship = od + rng.integers(1, 122, m)
    commit = od + rng.integers(30, 91, m)
    receipt = ship + rng.integers(1, 31, m)
    returned = np.where(rng.random(m) < 0.5, "R", "A")
    rflag = np.where(receipt <= CURRENT_DATE, returned, "N").astype(object)
    shipped = ship <= CURRENT_DATE
    lstatus = np.where(shipped, "F", "O").astype(object)
    f_per = np.bincount(np.repeat(np.arange(n), n_lines), weights=shipped,
                        minlength=n)
    status = np.where(f_per == n_lines, "F",
                      np.where(f_per == 0, "O", "P")).astype(object)
    gross = price * (100 - disc) * (100 + tax) // 10_000
    total = np.bincount(np.repeat(np.arange(n), n_lines),
                        weights=gross.astype(np.float64),
                        minlength=n).astype(np.int64)
    od_ = orders.dictionaries
    ld = li.dictionaries
    rf1_orders = {
        "o_orderkey": new_keys,
        "o_custkey": eligible[rng.integers(0, len(eligible), n)],
        "o_orderstatus": status, "o_totalprice": total,
        "o_orderdate": o_date,
        "o_orderpriority": _pick(rng, od_["o_orderpriority"], n),
        "o_clerk": _pick(rng, od_["o_clerk"], n),
        "o_shippriority": np.zeros(n, np.int64),
        "o_comment": _pick(rng, od_["o_comment"], n),
    }
    rf1_lineitem = {
        "l_orderkey": l_okey, "l_partkey": l_part, "l_suppkey": l_supp,
        "l_linenumber": l_line, "l_quantity": qty,
        "l_extendedprice": price, "l_discount": disc, "l_tax": tax,
        "l_returnflag": rflag, "l_linestatus": lstatus,
        "l_shipdate": ship, "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipinstruct": _pick(rng, ld["l_shipinstruct"], m),
        "l_shipmode": _pick(rng, ld["l_shipmode"], m),
        "l_comment": _pick(rng, ld["l_comment"], m),
        "l_key": lineitem_key(l_okey, l_line),
    }
    gone = np.sort(rng.choice(okey, size=min(n, len(okey)), replace=False))
    lokey = np.asarray(li.columns["l_orderkey"])
    hit = np.isin(lokey, gone)
    return {"rf1_orders": rf1_orders, "rf1_lineitem": rf1_lineitem,
            "rf2_orders": gone,
            "rf2_lineitem": lineitem_key(
                lokey[hit], np.asarray(li.columns["l_linenumber"])[hit])}


def _chunks(n: int, parts: int) -> list[np.ndarray]:
    return [c for c in np.array_split(np.arange(n), max(1, parts)) if len(c)]


def _run_txns(db: DB, fns) -> dict:
    retries0 = metric.TXN_RETRIES.value
    t0 = time.perf_counter()
    for fn in fns:
        db.txn(fn)
    _sync(db.engine.device)
    return {"txns": len(fns), "seconds": time.perf_counter() - t0,
            "retries": int(metric.TXN_RETRIES.value - retries0)}


def apply_rf1(cat: Catalog, db: DB, rf: dict, txns: int = 1) -> dict:
    """RF1: insert the new orders and their lineitems, `txns`
    transactions, each holding whole orders."""
    orders, li = cat.get("orders"), cat.get("lineitem")
    o, lr = rf["rf1_orders"], rf["rf1_lineitem"]
    fns = []
    for idx in _chunks(len(o["o_orderkey"]), txns):
        lsel = np.isin(lr["l_orderkey"], o["o_orderkey"][idx])

        def fn(t, idx=idx, lsel=lsel):
            orders.insert_rows(t, {c: a[idx] for c, a in o.items()})
            li.insert_rows(t, {c: a[lsel] for c, a in lr.items()})

        fns.append(fn)
    out = _run_txns(db, fns)
    out["rows"] = len(o["o_orderkey"]) + len(lr["l_orderkey"])
    return out


def apply_rf2(cat: Catalog, db: DB, rf: dict, txns: int = 1) -> dict:
    """RF2: delete the chosen orders and their lineitems through
    delete_pk, `txns` transactions."""
    orders, li = cat.get("orders"), cat.get("lineitem")
    gone, lkeys = rf["rf2_orders"], rf["rf2_lineitem"]
    fns = []
    for idx in _chunks(len(gone), txns):
        ls = lkeys[np.isin(lkeys >> 3, gone[idx])]

        def fn(t, idx=idx, ls=ls):
            for k in ls:
                li.delete_pk(t, int(k))
            for k in gone[idx]:
                orders.delete_pk(t, int(k))

        fns.append(fn)
    out = _run_txns(db, fns)
    out["rows"] = len(gone) + len(lkeys)
    return out


def _with_rows(t: Table, add: dict | None, drop: np.ndarray | None
               ) -> Table:
    """Host table `t` with `add`'s rows (STRING columns as values)
    appended and the rows where `drop` is True removed."""
    cols, values = {}, {}
    for name in t.schema.names:
        a = np.asarray(t.columns[name])
        d = t.dictionaries.get(name)
        if d is not None:
            values[name] = list(d.values)
        if add is not None:
            extra = add[name]
            if d is not None:
                code = {v: i for i, v in enumerate(values[name])}
                for v in extra:
                    if v not in code:
                        code[v] = len(values[name])
                        values[name].append(v)
                extra = np.array([code[v] for v in extra], dtype=a.dtype)
            a = np.concatenate([a, np.asarray(extra).astype(a.dtype)])
        if drop is not None:
            a = a[~drop]
        cols[name] = a
    return Table.from_codes(t.name, t.schema, cols, values,
                            ordering=t.ordering)


def refreshed_catalog(host: Catalog, rf: dict) -> Catalog:
    """The host catalog after RF1 and RF2: what the oracle reads."""
    out = Catalog(host.device)
    for name in TABLES:
        t = host.get(name)
        if name == "orders":
            drop = np.isin(np.concatenate([
                t.columns["o_orderkey"], rf["rf1_orders"]["o_orderkey"]]),
                rf["rf2_orders"])
            t = _with_rows(t, rf["rf1_orders"], drop)
        elif name == "lineitem":
            drop = np.isin(np.concatenate([
                t.columns["l_orderkey"], rf["rf1_lineitem"]["l_orderkey"]]),
                rf["rf2_orders"])
            t = _with_rows(t, rf["rf1_lineitem"], drop)
        out.add(t)
    return out


# ---------------------------------------------------------------------------
# secondary index


def index_engine(host: Catalog, device="cuda", wal_path: str | None = None
                 ) -> tuple[Catalog, DB, dict]:
    """orders in a second engine (key_width 24) with the index
    ``o_custkey_idx``: the table is created, the index added through the
    CREATE INDEX job (planned, backfilled over the empty table, swapped
    into the descriptor), then the rows bulk-load with their index
    entries beside them."""
    dev = resolve_device(device)
    orders = host.get("orders")
    eng = Engine(key_width=24, val_width=rowcodec.value_width(orders.schema),
                 memtable_size=1 << 20, wal_path=wal_path, device=dev)
    db = DB(eng, Clock())
    cat = Catalog(dev)
    create_kv_table(cat, db, "orders", orders.schema, "o_orderkey")
    reg = Registry(db)
    ixm.register_create_index_job(reg, cat)
    payload = ixm.plan_create_index(
        cat, db, ixm.CreateIndex("o_custkey_idx", "orders", "o_custkey"))
    job = reg.adopt_and_resume(reg.create("create_index", payload).job_id)
    eng.compact(bottom=True)  # the job's commits, one run each
    t0 = time.perf_counter()
    rows = cat.get("orders").bulk_load(host_columns(orders))
    _sync(dev)
    return cat, db, {"rows": rows, "load_s": time.perf_counter() - t0,
                     "job": job.state, "runs": len(eng.runs),
                     "device_bytes": engine_bytes(eng)}


def custkey_lookup(cat: Catalog, custkey: int) -> Rel:
    """SELECT o_orderkey, o_custkey, o_totalprice, o_orderdate FROM orders
    WHERE o_custkey = custkey."""
    r = Rel.scan(cat, "orders", ("o_orderkey", "o_custkey", "o_totalprice",
                                 "o_orderdate"))
    return r.filter(ex.Cmp("eq", r.c("o_custkey"), ex.Const(int(custkey),
                                                            INT64)))


def sorted_rows(res: dict) -> list:
    return sorted(zip(*(np.asarray(v).tolist() for v in res.values())))


# ---------------------------------------------------------------------------


def decode_seconds(root, dev: torch.device) -> float:
    """The KV decodes of one run of `root`'s scans, timed alone: each
    KVTable scan's ``device_batch`` into the table's scan buffers, as
    ScanOp makes it, synchronized."""
    from ..flow.operators import ScanOp

    total = 0.0
    stack = [root]
    while stack:
        op = stack.pop()
        stack.extend(op.children())
        if isinstance(op, ScanOp) and isinstance(op.table, KVTable):
            _sync(dev)
            t0 = time.perf_counter()
            op.table.device_batch(op.output_schema.names, persistent=True)
            _sync(dev)
            total += time.perf_counter() - t0
    return total


def run_tpch_kv(cat: Catalog, oracle_cat: Catalog, queries, runs: int = 5,
                device="cuda") -> dict:
    """`queries` over the KV catalog through ``bench/tpch_run.run_tpch``,
    every run held to the oracle of `oracle_cat`, each with the seconds
    of its KV decodes."""
    from ..plan import builder
    from . import queries as Q
    from .tpch_run import run_tpch

    dev = resolve_device(device)
    out = run_tpch(queries, runs=runs, device=dev, catalog=cat,
                   oracle_catalog=oracle_cat)
    for q in queries:
        root = builder.build(Q.QUERIES[q](cat).optimized_plan(), cat)
        out[q]["decode_s"] = decode_seconds(root, dev)
    return out


def main() -> int:
    from .tpch import gen_tpch
    from .tpch_run import LADDER

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=19920101)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dev = resolve_device(a.device)
    host = gen_tpch(sf=a.sf, seed=a.seed, device=dev)
    cat, db, load = load_tpch_kv(host, device=dev)
    res = {"load": load,
           "before": run_tpch_kv(cat, host, LADDER, a.runs, dev)}
    rf = gen_refresh(host, a.sf)
    res["rf1"] = apply_rf1(cat, db, rf)
    res["rf2"] = apply_rf2(cat, db, rf)
    res["after"] = run_tpch_kv(cat, refreshed_catalog(host, rf), LADDER,
                               a.runs, dev)
    for k in ("before", "after"):
        res[k] = {q: {f: res[k][q][f] for f in ("median_s", "decode_s")}
                  for q in LADDER}
    print(json.dumps(res, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
