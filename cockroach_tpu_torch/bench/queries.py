"""TPC-H queries as relational plans — the port of Q1 and Q3 of
``cockroach_tpu.bench.queries``, written against ``sql.rel.Rel``.
Plain numpy answers for both live in ``bench/tpch_oracle.py``.
"""

from __future__ import annotations

from ..catalog import Catalog
from ..ops import expr as ex
from ..sql.rel import Rel
from .tpch import d


def q1(cat: Catalog, delta_days: int = 90) -> Rel:
    """Pricing summary report: scan lineitem, filter shipdate, aggregate by
    (returnflag, linestatus), order by the same."""
    li = Rel.scan(cat, "lineitem", (
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_shipdate",
    ))
    cutoff = d("1998-12-01") - delta_days
    li = li.filter(ex.Cmp("le", li.c("l_shipdate"), ex.lit(cutoff)))
    one = ex.Const(1.0, li.type_of("l_discount"))
    disc_price = ex.BinOp("*", li.c("l_extendedprice"),
                          ex.BinOp("-", one, li.c("l_discount")))
    one_tax = ex.Const(1.0, li.type_of("l_tax"))
    charge = ex.BinOp("*", disc_price, ex.BinOp("+", one_tax, li.c("l_tax")))
    li = li.project([
        ("l_returnflag", li.c("l_returnflag")),
        ("l_linestatus", li.c("l_linestatus")),
        ("l_quantity", li.c("l_quantity")),
        ("l_extendedprice", li.c("l_extendedprice")),
        ("l_discount", li.c("l_discount")),
        ("disc_price", disc_price),
        ("charge", charge),
    ])
    g = li.groupby(
        ["l_returnflag", "l_linestatus"],
        [
            ("sum_qty", "sum", "l_quantity"),
            ("sum_base_price", "sum", "l_extendedprice"),
            ("sum_disc_price", "sum", "disc_price"),
            ("sum_charge", "sum", "charge"),
            ("avg_qty", "avg", "l_quantity"),
            ("avg_price", "avg", "l_extendedprice"),
            ("avg_disc", "avg", "l_discount"),
            ("count_order", "count_rows", None),
        ],
    )
    return g.sort([("l_returnflag", False), ("l_linestatus", False)])


def q3(cat: Catalog, segment: str = "BUILDING",
       date: str = "1995-03-15") -> Rel:
    """Shipping priority: customer x orders x lineitem, top 10 by revenue."""
    cust = Rel.scan(cat, "customer", ("c_custkey", "c_mktsegment"))
    cust = cust.filter(cust.str_eq("c_mktsegment", segment))
    orders = Rel.scan(
        cat, "orders",
        ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"),
    )
    orders = orders.filter(
        ex.Cmp("lt", orders.c("o_orderdate"), ex.lit(d(date)))
    )
    # orders ⋈ customer (FK->PK, unique build) — semi join keeps schema lean
    ord_c = orders.join(cust, on=[("o_custkey", "c_custkey")], how="semi")
    li = Rel.scan(
        cat, "lineitem",
        ("l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"),
    )
    li = li.filter(ex.Cmp("gt", li.c("l_shipdate"), ex.lit(d(date))))
    j = li.join(ord_c, on=[("l_orderkey", "o_orderkey")], how="inner")
    one = ex.Const(1.0, j.type_of("l_discount"))
    revenue = ex.BinOp("*", j.c("l_extendedprice"),
                       ex.BinOp("-", one, j.c("l_discount")))
    j = j.project([
        ("l_orderkey", j.c("l_orderkey")),
        ("revenue", revenue),
        ("o_orderdate", j.c("o_orderdate")),
        ("o_shippriority", j.c("o_shippriority")),
    ])
    g = j.groupby(
        ["l_orderkey", "o_orderdate", "o_shippriority"],
        [("revenue", "sum", "revenue")],
    )
    g = g.project([
        ("l_orderkey", g.c("l_orderkey")),
        ("revenue", g.c("revenue")),
        ("o_orderdate", g.c("o_orderdate")),
        ("o_shippriority", g.c("o_shippriority")),
    ])
    return g.sort([("revenue", True), ("o_orderdate", False)]).limit(10)


QUERIES = {"q1": q1, "q3": q3}
