"""TPC-DS workload (reduced) — the pkg/workload/tpcds analog; the port of
``cockroach_tpu.bench.tpcds``.

The reduction keeps the STAR-SCHEMA shape of the benchmark's reporting
class — a store_sales fact table against date_dim, item, store,
customer_demographics and promotion dimensions — and nine reporting
queries over it (q3, q7, q19_lite, q42, q52, q53_lite with its window,
q55, q59_lite, q65_lite), each a Rel plan. The generator is seeded and
deterministic, and the same seed gives the reference's tables column for
column; it is not dsdgen-compatible. ``bench/tpcds_oracle.py`` answers
the nine in numpy, ``bench/tpcds_run.py`` times them."""

from __future__ import annotations

import numpy as np

from ..catalog import Catalog, Table
from ..coldata.types import DECIMAL, FLOAT64, INT64, STRING, Schema
from ..ops import expr as ex
from ..sql.rel import Rel


def _eq(rel: Rel, col: str, v: int) -> Rel:
    return rel.filter(ex.Cmp("eq", rel.c(col), ex.lit(v)))

BRANDS = [f"brand#{i}" for i in range(1, 21)]
CATEGORIES = ["Sports", "Books", "Home", "Electronics", "Music",
              "Jewelry", "Shoes", "Men", "Women", "Children"]
MANAGERS = [f"mgr_{i}" for i in range(1, 9)]


def gen_tpcds(sf: float = 0.01, seed: int = 19980401,
              device="cuda") -> Catalog:
    """store_sales + date_dim + item + store + customer_demographics +
    promotion at roughly TPC-DS row ratios (store_sales 2.88 M rows per
    SF), generated on the host; tables upload to `device` column by
    column when first scanned."""
    rng = np.random.default_rng(seed)
    cat = Catalog(device)

    # date_dim: 5 years of days with (year, moy, dom) breakdown
    n_days = 5 * 365
    d_date_sk = np.arange(n_days, dtype=np.int64)
    years = 1998 + d_date_sk // 365
    doy = d_date_sk % 365
    moy = np.minimum(doy // 30 + 1, 12)
    cat.add(Table.from_strings(
        "date_dim",
        Schema.of(d_date_sk=INT64, d_year=INT64, d_moy=INT64, d_dom=INT64),
        {
            "d_date_sk": d_date_sk,
            "d_year": years.astype(np.int64),
            "d_moy": moy.astype(np.int64),
            "d_dom": (doy % 30 + 1).astype(np.int64),
        },
    ))

    n_item = max(40, int(18_000 * sf))
    i_item_sk = np.arange(n_item, dtype=np.int64)
    brand_id = rng.integers(1, len(BRANDS) + 1, n_item)
    cat.add(Table.from_strings(
        "item",
        Schema.of(i_item_sk=INT64, i_brand_id=INT64, i_brand=STRING,
                  i_category=STRING, i_manager_id=INT64,
                  i_manufact_id=INT64),
        {
            "i_item_sk": i_item_sk,
            "i_brand_id": brand_id.astype(np.int64),
            "i_brand": np.array(BRANDS, dtype=object)[brand_id - 1],
            "i_category": np.array(CATEGORIES, dtype=object)[
                rng.integers(0, len(CATEGORIES), n_item)],
            "i_manager_id": rng.integers(1, 9, n_item).astype(np.int64),
            "i_manufact_id": rng.integers(1, 21, n_item).astype(np.int64),
        },
    ))

    n_store = max(2, int(12 * sf * 10))
    cat.add(Table.from_strings(
        "store",
        Schema.of(s_store_sk=INT64, s_store_name=STRING),
        {
            "s_store_sk": np.arange(n_store, dtype=np.int64),
            "s_store_name": np.array(
                [f"store_{i}" for i in range(n_store)], dtype=object),
        },
    ))

    # customer_demographics: the full cross of the reduced attribute space
    genders = ["M", "F"]
    maritals = ["M", "S", "D", "W", "U"]
    educations = ["Primary", "Secondary", "College", "2 yr Degree",
                  "4 yr Degree", "Advanced Degree", "Unknown"]
    n_cd = len(genders) * len(maritals) * len(educations)
    g_idx = np.arange(n_cd) // (len(maritals) * len(educations))
    m_idx = (np.arange(n_cd) // len(educations)) % len(maritals)
    e_idx = np.arange(n_cd) % len(educations)
    cat.add(Table.from_strings(
        "customer_demographics",
        Schema.of(cd_demo_sk=INT64, cd_gender=STRING,
                  cd_marital_status=STRING, cd_education_status=STRING),
        {
            "cd_demo_sk": np.arange(n_cd, dtype=np.int64),
            "cd_gender": np.array(genders, dtype=object)[g_idx],
            "cd_marital_status": np.array(maritals, dtype=object)[m_idx],
            "cd_education_status": np.array(educations, dtype=object)[e_idx],
        },
    ))

    n_promo = max(4, int(300 * sf))
    cat.add(Table.from_strings(
        "promotion",
        Schema.of(p_promo_sk=INT64, p_channel_email=STRING,
                  p_channel_event=STRING),
        {
            "p_promo_sk": np.arange(n_promo, dtype=np.int64),
            "p_channel_email": np.array(
                ["N" if x < 0.9 else "Y" for x in rng.random(n_promo)],
                dtype=object),
            "p_channel_event": np.array(
                ["N" if x < 0.8 else "Y" for x in rng.random(n_promo)],
                dtype=object),
        },
    ))

    n_sales = int(2_880_000 * sf)
    price = rng.integers(100, 30_000, n_sales)  # cents
    list_price = price + rng.integers(0, 5_000, n_sales)
    cat.add(Table.from_strings(
        "store_sales",
        Schema.of(ss_sold_date_sk=INT64, ss_item_sk=INT64,
                  ss_store_sk=INT64, ss_cdemo_sk=INT64, ss_promo_sk=INT64,
                  ss_quantity=INT64, ss_ext_sales_price=DECIMAL(12, 2),
                  ss_list_price=DECIMAL(12, 2),
                  ss_coupon_amt=DECIMAL(12, 2)),
        {
            "ss_sold_date_sk": rng.integers(0, n_days, n_sales
                                            ).astype(np.int64),
            "ss_item_sk": rng.integers(0, n_item, n_sales).astype(np.int64),
            "ss_store_sk": rng.integers(0, n_store, n_sales
                                        ).astype(np.int64),
            "ss_cdemo_sk": rng.integers(0, n_cd, n_sales).astype(np.int64),
            "ss_promo_sk": rng.integers(0, n_promo, n_sales
                                        ).astype(np.int64),
            "ss_quantity": rng.integers(1, 100, n_sales).astype(np.int64),
            "ss_ext_sales_price": price.astype(np.int64),
            "ss_list_price": list_price.astype(np.int64),
            "ss_coupon_amt": (rng.integers(0, 500, n_sales)
                              * (rng.random(n_sales) < 0.3)).astype(np.int64),
        },
    ))
    return cat


# ---------------------------------------------------------------------------
# queries (Rel plans)


def q3(cat: Catalog) -> Rel:
    """TPC-DS Q3: brand revenue by year for one manufacturer in December."""
    ss = Rel.scan(cat, "store_sales",
                  ("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"))
    dd = _eq(Rel.scan(cat, "date_dim"), "d_moy", 12)
    it = _eq(Rel.scan(cat, "item"), "i_manufact_id", 5)
    j = (ss.join(dd, on=[("ss_sold_date_sk", "d_date_sk")])
         .join(it, on=[("ss_item_sk", "i_item_sk")]))
    g = j.groupby(["d_year", "i_brand_id", "i_brand"],
                  [("sum_agg", "sum", "ss_ext_sales_price")])
    return g.sort([("d_year", False), ("sum_agg", True),
                   ("i_brand_id", False)]).limit(100)


def q42(cat: Catalog) -> Rel:
    """TPC-DS Q42: category revenue for one month/year."""
    ss = Rel.scan(cat, "store_sales",
                  ("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"))
    dd = _eq(_eq(Rel.scan(cat, "date_dim"), "d_moy", 11), "d_year", 2000)
    it = Rel.scan(cat, "item")
    j = (ss.join(dd, on=[("ss_sold_date_sk", "d_date_sk")])
         .join(it, on=[("ss_item_sk", "i_item_sk")]))
    g = j.groupby(["d_year", "i_category"],
                  [("rev", "sum", "ss_ext_sales_price")])
    return g.sort([("rev", True), ("d_year", False),
                   ("i_category", False)]).limit(100)


def q52(cat: Catalog) -> Rel:
    """TPC-DS Q52: brand revenue for one month/year (ordered by revenue)."""
    ss = Rel.scan(cat, "store_sales",
                  ("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"))
    dd = _eq(_eq(Rel.scan(cat, "date_dim"), "d_moy", 12), "d_year", 1999)
    it = Rel.scan(cat, "item")
    j = (ss.join(dd, on=[("ss_sold_date_sk", "d_date_sk")])
         .join(it, on=[("ss_item_sk", "i_item_sk")]))
    g = j.groupby(["d_year", "i_brand_id", "i_brand"],
                  [("rev", "sum", "ss_ext_sales_price")])
    return g.sort([("d_year", False), ("rev", True),
                   ("i_brand_id", False)]).limit(100)


def q55(cat: Catalog) -> Rel:
    """TPC-DS Q55: brand revenue for one manager's items in one month."""
    ss = Rel.scan(cat, "store_sales",
                  ("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"))
    dd = _eq(_eq(Rel.scan(cat, "date_dim"), "d_moy", 11), "d_year", 2001)
    it = _eq(Rel.scan(cat, "item"), "i_manager_id", 3)
    j = (ss.join(dd, on=[("ss_sold_date_sk", "d_date_sk")])
         .join(it, on=[("ss_item_sk", "i_item_sk")]))
    g = j.groupby(["i_brand_id", "i_brand"],
                  [("rev", "sum", "ss_ext_sales_price")])
    return g.sort([("rev", True), ("i_brand_id", False)]).limit(100)


def q59_lite(cat: Catalog) -> Rel:
    """Q59 (reduced): weekly store revenue — store x month totals here
    (the full query's week-over-week self-join is out of this slice)."""
    ss = Rel.scan(cat, "store_sales",
                  ("ss_sold_date_sk", "ss_store_sk", "ss_ext_sales_price"))
    dd = Rel.scan(cat, "date_dim")
    st = Rel.scan(cat, "store")
    j = (ss.join(dd, on=[("ss_sold_date_sk", "d_date_sk")])
         .join(st, on=[("ss_store_sk", "s_store_sk")]))
    g = j.groupby(["s_store_name", "d_year", "d_moy"],
                  [("rev", "sum", "ss_ext_sales_price")])
    return g.sort([("s_store_name", False), ("d_year", False),
                   ("d_moy", False)]).limit(500)


def q7(cat: Catalog) -> Rel:
    """TPC-DS Q7: average quantity/list price/coupon/sales price per item
    for one demographic slice, excluding promoted-by-email sales."""
    ss = Rel.scan(cat, "store_sales",
                  ("ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk",
                   "ss_promo_sk", "ss_quantity", "ss_ext_sales_price",
                   "ss_list_price", "ss_coupon_amt"))
    dd = _eq(Rel.scan(cat, "date_dim"), "d_year", 2000)
    cd = Rel.scan(cat, "customer_demographics")
    cd = cd.filter(cd.str_eq("cd_gender", "M"))
    cd = cd.filter(cd.str_eq("cd_marital_status", "S"))
    cd = cd.filter(cd.str_eq("cd_education_status", "College"))
    pr = Rel.scan(cat, "promotion")
    pr = pr.filter(pr.str_eq("p_channel_email", "N"))
    it = Rel.scan(cat, "item", ("i_item_sk", "i_brand_id"))
    j = (ss.join(dd, on=[("ss_sold_date_sk", "d_date_sk")])
         .join(cd, on=[("ss_cdemo_sk", "cd_demo_sk")])
         .join(pr, on=[("ss_promo_sk", "p_promo_sk")])
         .join(it, on=[("ss_item_sk", "i_item_sk")]))
    g = j.groupby(["i_brand_id"], [
        ("agg1", "avg", "ss_quantity"),
        ("agg2", "avg", "ss_list_price"),
        ("agg3", "avg", "ss_coupon_amt"),
        ("agg4", "avg", "ss_ext_sales_price"),
    ])
    return g.sort([("i_brand_id", False)]).limit(100)


def q19_lite(cat: Catalog) -> Rel:
    """TPC-DS Q19 (reduced): brand revenue for one manager cohort in one
    month — manufacturer breakdown without the customer-geography anti
    filter (no customer_address table in this slice)."""
    ss = Rel.scan(cat, "store_sales",
                  ("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"))
    dd = _eq(_eq(Rel.scan(cat, "date_dim"), "d_moy", 11), "d_year", 1999)
    it = _eq(Rel.scan(cat, "item"), "i_manager_id", 7)
    j = (ss.join(dd, on=[("ss_sold_date_sk", "d_date_sk")])
         .join(it, on=[("ss_item_sk", "i_item_sk")]))
    g = j.groupby(["i_brand_id", "i_brand", "i_manufact_id"],
                  [("ext_price", "sum", "ss_ext_sales_price")])
    return g.sort([("ext_price", True), ("i_brand_id", False),
                   ("i_manufact_id", False)]).limit(100)


def q53_lite(cat: Catalog) -> Rel:
    """TPC-DS Q53 (reduced): manufacturers whose monthly revenue deviates
    from their average monthly revenue — the avg-as-window-over-partition
    shape (sum per (manufact, month), avg of those sums per manufact)."""
    ss = Rel.scan(cat, "store_sales",
                  ("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"))
    dd = Rel.scan(cat, "date_dim")
    it = Rel.scan(cat, "item", ("i_item_sk", "i_manufact_id"))
    j = (ss.join(dd, on=[("ss_sold_date_sk", "d_date_sk")])
         .join(it, on=[("ss_item_sk", "i_item_sk")]))
    g = j.groupby(["i_manufact_id", "d_year", "d_moy"],
                  [("sum_sales", "sum", "ss_ext_sales_price")])
    w = g.window(["i_manufact_id"], [("d_year", False), ("d_moy", False)],
                 [("avg_monthly", "avg", "sum_sales")])
    dev = w.filter(ex.Cmp(
        "gt",
        ex.Func1("abs", ex.BinOp(
            "-", ex.Cast(w.c("sum_sales"), FLOAT64), w.c("avg_monthly"))),
        ex.BinOp("*", ex.Const(0.1, FLOAT64), w.c("avg_monthly")),
    ))
    return dev.sort([("i_manufact_id", False), ("d_year", False),
                     ("d_moy", False)]).limit(200)


def q65_lite(cat: Catalog) -> Rel:
    """TPC-DS Q65 (reduced): store/item pairs whose revenue falls below
    95% of the store's average item revenue — an aggregate joined against
    an aggregate of itself (the reference's sa/sc sub-aggregation join;
    spec uses 10% but this generator's uniform sales concentrate per-item
    revenue near the mean, so 95% keeps the predicate selective)."""
    ss = Rel.scan(cat, "store_sales",
                  ("ss_item_sk", "ss_store_sk", "ss_ext_sales_price"))
    per_item = ss.groupby(["ss_store_sk", "ss_item_sk"],
                          [("revenue", "sum", "ss_ext_sales_price")])
    per_store = per_item.groupby(
        ["ss_store_sk"], [("ave", "avg", "revenue")]
    )
    per_store = per_store.project([
        ("sb_store_sk", per_store.c("ss_store_sk")),
        ("ave", per_store.c("ave")),
    ])
    j = per_item.join(per_store, on=[("ss_store_sk", "sb_store_sk")])
    low = j.filter(ex.Cmp(
        "le", ex.Cast(j.c("revenue"), FLOAT64),
        ex.BinOp("*", ex.Const(0.95, FLOAT64), j.c("ave")),
    ))
    st = Rel.scan(cat, "store")
    out = low.join(st, on=[("ss_store_sk", "s_store_sk")])
    return out.sort([("s_store_name", False), ("ss_item_sk", False)]
                    ).limit(200)


QUERIES = {"q3": q3, "q7": q7, "q19_lite": q19_lite, "q42": q42,
           "q52": q52, "q53_lite": q53_lite, "q55": q55,
           "q59_lite": q59_lite, "q65_lite": q65_lite}


def sales_window(cat: Catalog) -> Rel:
    """A full-size window over store_sales (not one of the nine): per
    store, by sale date, row_number, rank, the running revenue (ROWS
    UNBOUNDED PRECEDING .. CURRENT ROW) and the minimum sale of the last
    three rows (ROWS 2 PRECEDING .. CURRENT ROW, the sparse-table range
    minimum)."""
    from ..ops.sort import SortKey
    from ..ops.window import WindowSpec, window_output_schema
    from ..plan import spec as S

    ss = Rel.scan(cat, "store_sales",
                  ("ss_store_sk", "ss_sold_date_sk", "ss_ext_sales_price"))
    price = ss.idx("ss_ext_sales_price")
    specs = (WindowSpec("row_number", None, "rn"),
             WindowSpec("rank", None, "rk"),
             WindowSpec("sum", price, "run_sales", running=True),
             WindowSpec("min", price, "min3", frame=(2, 0)))
    node = S.Window(ss.plan, (ss.idx("ss_store_sk"),),
                    (SortKey(ss.idx("ss_sold_date_sk")),), specs)
    return Rel(cat, node, window_output_schema(ss.schema, specs), {})
