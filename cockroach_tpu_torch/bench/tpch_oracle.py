"""Plain numpy answers for TPC-H Q1 and Q3 over a catalog's host columns —
the oracle the port's results are held to on the card. Independent of the
engine: no plan, no operator, no torch; integer arithmetic for every
DECIMAL sum, so those answers are exact.

Each function returns {column name: numpy array} in the layout
``flow.runtime.run_operator`` gives: DECIMAL as float64 value / 10^scale,
STRING decoded to Python strings, rows in the query's ORDER BY order
(ties broken the way a stable sort of the grouped rows breaks them).
"""

from __future__ import annotations

import numpy as np

from .tpch import d

# FLOAT64 columns held within a relative bound; every other column is
# held exactly
FLOAT_COLUMNS = {"q1": ("avg_qty", "avg_price", "avg_disc"), "q3": ()}
FLOAT_RTOL = 1e-12  # bench.py's bound for float aggregates


def _col(cat, table: str, name: str) -> np.ndarray:
    return np.asarray(cat.get(table).columns[name])


def _strings(cat, table: str, name: str) -> np.ndarray:
    t = cat.get(table)
    return t.dictionaries[name].values[np.asarray(t.columns[name])]


def q1(cat, delta_days: int = 90) -> dict[str, np.ndarray]:
    """Pricing summary report, grouped by (returnflag, linestatus)."""
    keep = _col(cat, "lineitem", "l_shipdate") <= d("1998-12-01") - delta_days
    rf = _strings(cat, "lineitem", "l_returnflag")[keep].astype(str)
    ls = _strings(cat, "lineitem", "l_linestatus")[keep].astype(str)
    qty = _col(cat, "lineitem", "l_quantity")[keep]
    price = _col(cat, "lineitem", "l_extendedprice")[keep]
    disc = _col(cat, "lineitem", "l_discount")[keep]
    tax = _col(cat, "lineitem", "l_tax")[keep]
    disc_price = price * (100 - disc)  # scale 4
    charge = disc_price * (100 + tax)  # scale 6
    out: dict[str, list] = {k: [] for k in (
        "l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
        "sum_disc_price", "sum_charge", "avg_qty", "avg_price", "avg_disc",
        "count_order")}
    for f, s in sorted(set(zip(rf, ls))):
        g = (rf == f) & (ls == s)
        n = int(g.sum())
        out["l_returnflag"].append(f)
        out["l_linestatus"].append(s)
        out["sum_qty"].append(int(qty[g].sum()) / 100.0)
        out["sum_base_price"].append(int(price[g].sum()) / 100.0)
        out["sum_disc_price"].append(int(disc_price[g].sum()) / 1e4)
        out["sum_charge"].append(int(charge[g].sum()) / 1e6)
        out["avg_qty"].append(float(qty[g].sum()) / n / 100.0)
        out["avg_price"].append(float(price[g].sum()) / n / 100.0)
        out["avg_disc"].append(float(disc[g].sum()) / n / 100.0)
        out["count_order"].append(n)
    res = {k: np.array(v) for k, v in out.items()}
    for k in ("l_returnflag", "l_linestatus"):
        res[k] = res[k].astype(object)
    res["count_order"] = res["count_order"].astype(np.int64)
    return res


def q3(cat, segment: str = "BUILDING",
       date: str = "1995-03-15") -> dict[str, np.ndarray]:
    """Shipping priority: top 10 unshipped orders by revenue."""
    cutoff = d(date)
    cust_key = _col(cat, "customer", "c_custkey")
    building = _strings(cat, "customer", "c_mktsegment").astype(str) == segment
    good_cust = np.zeros(int(cust_key.max()) + 2, dtype=bool)
    good_cust[cust_key[building]] = True

    o_key = _col(cat, "orders", "o_orderkey")
    o_date = _col(cat, "orders", "o_orderdate")
    o_prio = _col(cat, "orders", "o_shippriority")
    o_ok = (o_date < cutoff) & good_cust[_col(cat, "orders", "o_custkey")]
    order_row = np.full(int(o_key.max()) + 2, -1, dtype=np.int64)
    order_row[o_key[o_ok]] = np.nonzero(o_ok)[0]

    l_key = _col(cat, "lineitem", "l_orderkey")
    row = order_row[l_key]
    keep = (_col(cat, "lineitem", "l_shipdate") > cutoff) & (row >= 0)
    key = l_key[keep]
    revenue = (_col(cat, "lineitem", "l_extendedprice")[keep]
               * (100 - _col(cat, "lineitem", "l_discount")[keep]))  # scale 4
    order = np.argsort(key, kind="stable")
    key, revenue, row = key[order], revenue[order], row[keep][order]
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    g_key = key[starts]
    g_rev = np.add.reduceat(revenue, starts) if len(key) else revenue
    g_date = o_date[row[starts]]
    g_prio = o_prio[row[starts]]
    # ORDER BY revenue DESC, o_orderdate; equal keys keep group-key order
    top = np.lexsort((g_key, g_date, -g_rev))[:10]
    return {
        "l_orderkey": g_key[top],
        "revenue": g_rev[top] / 1e4,
        "o_orderdate": g_date[top],
        "o_shippriority": g_prio[top],
    }


ORACLES = {"q1": q1, "q3": q3}


def mismatch(query: str, got: dict, want: dict) -> str | None:
    """None when `got` equals `want` (FLOAT_COLUMNS within FLOAT_RTOL,
    every other column exactly), else where they first differ."""
    if list(got) != list(want):
        return f"{query}: columns {list(got)} != {list(want)}"
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        if a.shape != b.shape:
            return f"{query}.{name}: {a.shape[0]} rows != {b.shape[0]}"
        if name in FLOAT_COLUMNS[query]:
            same = np.isclose(a.astype(np.float64), b.astype(np.float64),
                              rtol=FLOAT_RTOL, atol=0.0)
        else:
            same = a == b
        if not np.all(same):
            i = int(np.flatnonzero(~np.asarray(same))[0])
            return f"{query}.{name} row {i}: {a[i]!r} != {b[i]!r}"
    return None
