"""Plain numpy answers for the nine reduced TPC-DS queries of
``bench/tpcds.py`` over a catalog's host columns — the oracle the port's
results are held to on the card. Independent of the engine: no plan, no
operator, no torch. Joins against the dimensions are lookups (every
dimension key is its row index), groups come from ``np.unique`` over a
mixed-radix key, and every DECIMAL sum is an integer sum, so those
answers are exact.

Each function returns {column name: numpy array} in the layout
``flow.runtime.run_operator`` gives: DECIMAL as float64 value / 100,
STRING decoded to Python strings, rows in the query's ORDER BY order
(each query's keys order its rows totally).
"""

from __future__ import annotations

import numpy as np

# FLOAT64 output columns, held within FLOAT_RTOL; every other column
# (INT, DECIMAL, STRING) is held exactly
FLOAT_COLUMNS = {q: () for q in ("q3", "q7", "q19_lite", "q42", "q52",
                                 "q53_lite", "q55", "q59_lite", "q65_lite",
                                 "sales_window")}
FLOAT_COLUMNS.update({"q7": ("agg1", "agg2", "agg3", "agg4"),
                      "q53_lite": ("avg_monthly",), "q65_lite": ("ave",)})
FLOAT_RTOL = 1e-12


def _col(cat, table: str, name: str) -> np.ndarray:
    return np.asarray(cat.get(table).columns[name])


def _values(cat, table: str, name: str) -> np.ndarray:
    return np.asarray(cat.get(table).dictionaries[name].values, dtype=object)


def _rank(cat, table: str, name: str) -> np.ndarray:
    """Dictionary code -> rank of its value in byte order."""
    vals = _values(cat, table, name).astype(str)
    rank = np.empty(len(vals), dtype=np.int64)
    rank[np.argsort(vals, kind="stable")] = np.arange(len(vals))
    return rank


def _group(keys: list[np.ndarray]):
    """(first row of each group, group id per row), groups in ascending
    lexicographic key order; keys are non-negative integers."""
    combined = np.zeros(len(keys[0]), dtype=np.int64)
    for k in keys:
        k = np.asarray(k, dtype=np.int64)
        combined = combined * (int(k.max(initial=0)) + 1) + k
    _, first, inv = np.unique(combined, return_index=True,
                              return_inverse=True)
    return first, inv.reshape(-1)


def _sum(inv: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """Exact integer group sums (float64 accumulation stays under 2^53
    at every scale these queries run)."""
    return np.bincount(inv, weights=vals, minlength=n).round().astype(
        np.int64)


def _sales(cat, *names):
    return [_col(cat, "store_sales", n) for n in names]


def _dates(cat):
    return (_col(cat, "date_dim", "d_year"), _col(cat, "date_dim", "d_moy"))


def _brand_revenue(cat, keep, rev: str):
    """q3/q52: (d_year, i_brand_id, i_brand) revenue of the kept rows,
    by year, revenue descending, brand id; top 100."""
    date, item, price = _sales(cat, "ss_sold_date_sk", "ss_item_sk",
                               "ss_ext_sales_price")
    year, _ = _dates(cat)
    date, item, price = date[keep], item[keep], price[keep]
    brand_id = _col(cat, "item", "i_brand_id")[item]
    brand = _col(cat, "item", "i_brand")[item]
    y = year[date]
    first, inv = _group([y, brand_id, _rank(cat, "item", "i_brand")[brand]])
    s = _sum(inv, price, len(first))
    gy, gid, gb = y[first], brand_id[first], brand[first]
    order = np.lexsort((gid, -s, gy))[:100]
    return {"d_year": gy[order], "i_brand_id": gid[order],
            "i_brand": _values(cat, "item", "i_brand")[gb[order]],
            rev: s[order] / 100.0}


def q3(cat) -> dict:
    date, item = _sales(cat, "ss_sold_date_sk", "ss_item_sk")
    _, moy = _dates(cat)
    keep = (moy[date] == 12) & (_col(cat, "item", "i_manufact_id")[item] == 5)
    return _brand_revenue(cat, keep, "sum_agg")


def q52(cat) -> dict:
    date, = _sales(cat, "ss_sold_date_sk")
    year, moy = _dates(cat)
    keep = (moy[date] == 12) & (year[date] == 1999)
    return _brand_revenue(cat, keep, "rev")


def q42(cat) -> dict:
    date, item, price = _sales(cat, "ss_sold_date_sk", "ss_item_sk",
                               "ss_ext_sales_price")
    year, moy = _dates(cat)
    keep = (moy[date] == 11) & (year[date] == 2000)
    y = year[date[keep]]
    catg = _col(cat, "item", "i_category")[item[keep]]
    first, inv = _group([y, _rank(cat, "item", "i_category")[catg]])
    s = _sum(inv, price[keep], len(first))
    gy, gc = y[first], catg[first]
    order = np.lexsort((_rank(cat, "item", "i_category")[gc], gy, -s))[:100]
    return {"d_year": gy[order],
            "i_category": _values(cat, "item", "i_category")[gc[order]],
            "rev": s[order] / 100.0}


def _manager_brands(cat, moy_v, year_v, manager, manufact: bool):
    date, item, price = _sales(cat, "ss_sold_date_sk", "ss_item_sk",
                               "ss_ext_sales_price")
    year, moy = _dates(cat)
    keep = ((moy[date] == moy_v) & (year[date] == year_v)
            & (_col(cat, "item", "i_manager_id")[item] == manager))
    item, price = item[keep], price[keep]
    bid = _col(cat, "item", "i_brand_id")[item]
    brand = _col(cat, "item", "i_brand")[item]
    keys = [bid, _rank(cat, "item", "i_brand")[brand]]
    if manufact:
        mf = _col(cat, "item", "i_manufact_id")[item]
        keys.append(mf)
    first, inv = _group(keys)
    s = _sum(inv, price, len(first))
    out = {"i_brand_id": bid[first],
           "i_brand": _values(cat, "item", "i_brand")[brand[first]]}
    if manufact:
        out["i_manufact_id"] = mf[first]
        order = np.lexsort((out["i_manufact_id"], out["i_brand_id"], -s))
    else:
        order = np.lexsort((out["i_brand_id"], -s))
    order = order[:100]
    out = {k: v[order] for k, v in out.items()}
    return out, s[order] / 100.0


def q55(cat) -> dict:
    out, rev = _manager_brands(cat, 11, 2001, 3, False)
    return {**out, "rev": rev}


def q19_lite(cat) -> dict:
    out, rev = _manager_brands(cat, 11, 1999, 7, True)
    return {**out, "ext_price": rev}


def q59_lite(cat) -> dict:
    date, store, price = _sales(cat, "ss_sold_date_sk", "ss_store_sk",
                                "ss_ext_sales_price")
    year, moy = _dates(cat)
    name = _col(cat, "store", "s_store_name")[store]
    nrank = _rank(cat, "store", "s_store_name")[name]
    y, m = year[date], moy[date]
    first, inv = _group([nrank, y, m])
    s = _sum(inv, price, len(first))
    order = np.arange(len(first))[:500]  # the group order is the ORDER BY
    return {"s_store_name": _values(cat, "store", "s_store_name")[
                name[first][order]],
            "d_year": y[first][order], "d_moy": m[first][order],
            "rev": s[order] / 100.0}


def q7(cat) -> dict:
    date, item, cdemo, promo, qty, lprice, coupon, price = _sales(
        cat, "ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk", "ss_promo_sk",
        "ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_ext_sales_price")
    year, _ = _dates(cat)

    def is_(table, col, v):
        return _values(cat, table, col)[_col(cat, table, col)] == v

    cd_ok = (is_("customer_demographics", "cd_gender", "M")
             & is_("customer_demographics", "cd_marital_status", "S")
             & is_("customer_demographics", "cd_education_status", "College"))
    pr_ok = is_("promotion", "p_channel_email", "N")
    keep = (year[date] == 2000) & cd_ok[cdemo] & pr_ok[promo]
    bid = _col(cat, "item", "i_brand_id")[item[keep]]
    first, inv = _group([bid])
    n = np.bincount(inv, minlength=len(first))
    out = {"i_brand_id": bid[first]}
    for name, v, scale in (("agg1", qty, 1.0), ("agg2", lprice, 100.0),
                           ("agg3", coupon, 100.0), ("agg4", price, 100.0)):
        s = _sum(inv, v[keep], len(first)).astype(np.float64)
        out[name] = s / n if scale == 1.0 else s / n / scale
    return {k: a[:100] for k, a in out.items()}


def q53_lite(cat) -> dict:
    date, item, price = _sales(cat, "ss_sold_date_sk", "ss_item_sk",
                               "ss_ext_sales_price")
    year, moy = _dates(cat)
    mf = _col(cat, "item", "i_manufact_id")[item]
    y, m = year[date], moy[date]
    first, inv = _group([mf, y, m])
    s = _sum(inv, price, len(first))
    gmf = mf[first]
    # avg over each manufacturer's partition of monthly sums
    pfirst, pinv = _group([gmf])
    psum = np.bincount(pinv, weights=s.astype(np.float64))
    pn = np.bincount(pinv).astype(np.float64)
    avg = psum[pinv] / pn[pinv] / 100.0
    dev = np.abs(s / 100.0 - avg) > 0.1 * avg
    idx = np.flatnonzero(dev)[:200]  # the group order is the ORDER BY
    return {"i_manufact_id": gmf[idx], "d_year": y[first][idx],
            "d_moy": m[first][idx], "sum_sales": s[idx] / 100.0,
            "avg_monthly": avg[idx]}


def q65_lite(cat) -> dict:
    item, store, price = _sales(cat, "ss_item_sk", "ss_store_sk",
                                "ss_ext_sales_price")
    first, inv = _group([store, item])
    rev = _sum(inv, price, len(first))
    gstore, gitem = store[first], item[first]
    sfirst, sinv = _group([gstore])
    ave = (np.bincount(sinv, weights=rev.astype(np.float64))
           / np.bincount(sinv).astype(np.float64) / 100.0)[sinv]
    low = rev / 100.0 <= 0.95 * ave
    name = _col(cat, "store", "s_store_name")[gstore[low]]
    order = np.lexsort((gitem[low], _rank(cat, "store",
                                          "s_store_name")[name]))[:200]
    st, it = gstore[low][order], gitem[low][order]
    return {"ss_store_sk": st, "ss_item_sk": it,
            "revenue": rev[low][order] / 100.0, "sb_store_sk": st,
            "ave": ave[low][order], "s_store_sk": st,
            "s_store_name": _values(cat, "store", "s_store_name")[
                name[order]]}


ORACLES = {"q3": q3, "q7": q7, "q19_lite": q19_lite, "q42": q42,
           "q52": q52, "q53_lite": q53_lite, "q55": q55,
           "q59_lite": q59_lite, "q65_lite": q65_lite}


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


def sales_window(cat) -> dict:
    """bench/tpcds.sales_window: rows sorted by (store, date), ties in
    table order, as the engine's stable sort leaves them."""
    store, date, price = _sales(cat, "ss_store_sk", "ss_sold_date_sk",
                                "ss_ext_sales_price")
    order = np.lexsort((date, store))
    s, d, p = store[order], date[order], price[order]
    pos = np.arange(len(s))
    new_part = np.r_[True, s[1:] != s[:-1]]
    start = np.maximum.accumulate(np.where(new_part, pos, 0))
    new_peer = new_part | np.r_[True, d[1:] != d[:-1]]
    head = np.maximum.accumulate(np.where(new_peer, pos, 0))
    cs = np.cumsum(p)
    before = np.where(start > 0, cs[np.maximum(start - 1, 0)], 0)
    m3 = p.copy()
    for k in (1, 2):
        prev = np.r_[np.full(k, np.iinfo(np.int64).max), p[:-k]]
        m3 = np.where(pos - k >= start, np.minimum(m3, prev), m3)
    return {"ss_store_sk": s, "ss_sold_date_sk": d,
            "ss_ext_sales_price": p / 100.0, "rn": pos - start + 1,
            "rk": head - start + 1, "run_sales": (cs - before) / 100.0,
            "min3": m3 / 100.0}
