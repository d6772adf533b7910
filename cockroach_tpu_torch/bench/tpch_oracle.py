"""Plain numpy answers for TPC-H Q1, Q3, Q9 and Q18 (bench.py's ladder)
over a catalog's host columns — the oracle the port's results are held to
on the card. Independent of the engine: no plan, no operator, no torch;
integer arithmetic for every DECIMAL sum, so those answers are exact.
Q9 and Q18 are bench.py's pandas baselines (``_pandas_baseline``)
rewritten in numpy.

Each function returns {column name: numpy array} in the layout
``flow.runtime.run_operator`` gives: DECIMAL as float64 value / 10^scale,
STRING decoded to Python strings, rows in the query's ORDER BY order
(ties broken the way a stable sort of the grouped rows breaks them).
"""

from __future__ import annotations

import numpy as np

from .tpch import d

# FLOAT64 output columns of every query, held within a relative bound;
# every other column (INT, DECIMAL, DATE, BOOL, STRING) is held exactly
FLOAT_COLUMNS = {f"q{i}": () for i in range(1, 23)}
FLOAT_COLUMNS.update({
    "q1": ("avg_qty", "avg_price", "avg_disc"), "q8": ("mkt_share",),
    "q14": ("promo_revenue",), "q17": ("avg_yearly",),
})
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


def _lookup(keys: np.ndarray, values: np.ndarray, fill=-1) -> np.ndarray:
    """A dense key -> value table over non-negative integer keys."""
    out = np.full(int(keys.max()) + 2, fill, dtype=values.dtype)
    out[keys] = values
    return out


def _year(days: np.ndarray) -> np.ndarray:
    """Calendar year of days since 1970-01-01."""
    return (np.datetime64("1970-01-01", "D") + days.astype("timedelta64[D]")
            ).astype("datetime64[Y]").astype(np.int64) + 1970


def q9(cat, color: str = "green") -> dict[str, np.ndarray]:
    """Product type profit: profit of the lines of parts whose name holds
    `color`, by supplier nation and order year (nation ascending, year
    descending)."""
    names = cat.get("part").dictionaries["p_name"].values
    has = np.array([color in str(v) for v in names], dtype=bool)
    p_key = _col(cat, "part", "p_partkey")
    part_ok = _lookup(p_key, has[_col(cat, "part", "p_name")], False)

    l_part = _col(cat, "lineitem", "l_partkey")
    keep = part_ok[l_part]
    l_part = l_part[keep]
    l_supp = _col(cat, "lineitem", "l_suppkey")[keep]
    l_order = _col(cat, "lineitem", "l_orderkey")[keep]
    qty = _col(cat, "lineitem", "l_quantity")[keep]
    price = _col(cat, "lineitem", "l_extendedprice")[keep]
    disc = _col(cat, "lineitem", "l_discount")[keep]

    # partsupp by (partkey, suppkey): binary search of the packed pair
    ps_part = _col(cat, "partsupp", "ps_partkey")
    ps_supp = _col(cat, "partsupp", "ps_suppkey")
    width = int(max(ps_supp.max(), l_supp.max() if len(l_supp) else 0)) + 1
    ps_pack = ps_part * width + ps_supp
    order = np.argsort(ps_pack, kind="stable")
    packed = l_part * width + l_supp
    at = np.clip(np.searchsorted(ps_pack[order], packed), 0, len(order) - 1)
    found = ps_pack[order][at] == packed
    cost = _col(cat, "partsupp", "ps_supplycost")[order][at][found]
    l_supp, l_order = l_supp[found], l_order[found]
    qty, price, disc = qty[found], price[found], disc[found]

    s_nation = _lookup(_col(cat, "supplier", "s_suppkey"),
                       _col(cat, "supplier", "s_nationkey"))[l_supp]
    year = _year(_lookup(_col(cat, "orders", "o_orderkey"),
                         _col(cat, "orders", "o_orderdate"))[l_order])
    amount = price * (100 - disc) - cost * qty  # scale 4

    groups, inv = np.unique(s_nation * 10000 + year, return_inverse=True)
    sums = np.zeros(len(groups), dtype=np.int64)
    np.add.at(sums, inv, amount)
    n_name = _lookup(_col(cat, "nation", "n_nationkey"),
                     _strings(cat, "nation", "n_name").astype(str).astype(
                         object), None)[groups // 10000]
    g_year = groups % 10000
    top = np.lexsort((-g_year, n_name.astype(str)))
    return {"nation": n_name[top], "o_year": g_year[top],
            "sum_profit": sums[top] / 1e4}


def q18(cat, quantity: int = 300) -> dict[str, np.ndarray]:
    """Large volume customer: orders whose lines sum to more than
    `quantity` units, top 100 by total price, then order date (ties in
    group-key order: customer name, customer key, order key)."""
    l_key = _col(cat, "lineitem", "l_orderkey")
    # scale 2; a float64 bincount is exact here (sums stay under 2^53)
    sums = np.bincount(l_key, weights=_col(cat, "lineitem", "l_quantity"),
                       minlength=int(l_key.max()) + 2).astype(np.int64)

    o_key = _col(cat, "orders", "o_orderkey")
    big = sums[o_key] > quantity * 100
    o_key = o_key[big]
    o_cust = _col(cat, "orders", "o_custkey")[big]
    o_date = _col(cat, "orders", "o_orderdate")[big]
    o_price = _col(cat, "orders", "o_totalprice")[big]
    c_code = _lookup(_col(cat, "customer", "c_custkey"),
                     _col(cat, "customer", "c_name").astype(np.int64))
    name_code = c_code[o_cust]
    top = np.lexsort((o_key, o_cust, name_code, o_date, -o_price))[:100]
    names = cat.get("customer").dictionaries["c_name"].values
    return {
        "c_name": names[name_code[top]].astype(object),
        "c_custkey": o_cust[top],
        "o_orderkey": o_key[top],
        "o_orderdate": o_date[top],
        "o_totalprice": o_price[top] / 100.0,
        "sum_qty": sums[o_key[top]] / 100.0,
    }


ORACLES = {"q1": q1, "q3": q3, "q9": q9, "q18": q18}


def mismatch(query: str, got: dict, want: dict) -> str | None:
    """None when `got` equals `want` (FLOAT_COLUMNS within FLOAT_RTOL,
    every other column exactly, NULL only equal to NULL), else where they
    first differ."""
    if list(got) != list(want):
        return f"{query}: columns {list(got)} != {list(want)}"
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        if a.shape != b.shape:
            return f"{query}.{name}: {a.shape[0]} rows != {b.shape[0]}"
        if name in FLOAT_COLUMNS[query]:
            # NULL (None) only equals NULL; values within the bound
            na = np.array([x is None for x in a], dtype=bool)
            nb = np.array([x is None for x in b], dtype=bool)
            fa = np.where(na, 0.0, a).astype(np.float64)
            fb = np.where(nb, 0.0, b).astype(np.float64)
            same = (na == nb) & np.isclose(fa, fb, rtol=FLOAT_RTOL, atol=0.0)
        else:
            same = a == b
        if not np.all(same):
            i = int(np.flatnonzero(~np.asarray(same))[0])
            return f"{query}.{name} row {i}: {a[i]!r} != {b[i]!r}"
    return None
