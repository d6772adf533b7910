"""TPC-H data generator — the port of ``cockroach_tpu.bench.tpch``:
schema-faithful, vectorized numpy, seeded. The same seed gives the same
arrays as the reference; tables land in a Catalog on ``device``.

Distributions follow the TPC-H spec / dbgen where they affect query
selectivity (dates, quantities, discounts, return flags, retail prices,
the 2/3-of-customers-have-orders rule); text columns use a bounded
comment pool instead of dbgen's grammar.

Scale: SF1 = 1.5M orders / ~6M lineitems / 150k customers / 200k parts /
10k suppliers / 800k partsupp, per spec.
"""

from __future__ import annotations

import numpy as np

from ..catalog import Catalog, Table
from ..coldata.types import DATE, DECIMAL, INT64, STRING, Schema
from ..device import resolve_device

EPOCH = np.datetime64("1970-01-01")
START_DATE = (np.datetime64("1992-01-01") - EPOCH).astype(int)  # 8035
END_DATE = (np.datetime64("1998-08-02") - EPOCH).astype(int)
CURRENT_DATE = (np.datetime64("1995-06-17") - EPOCH).astype(int)


def d(s: str) -> int:
    """'YYYY-MM-DD' -> days since epoch (for query literals)."""
    return int((np.datetime64(s) - EPOCH).astype(int))


NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_SYL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_SYL1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_SYL2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
P_NAME_WORDS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow"
).split()
COMMENT_WORDS = (
    "furiously carefully quickly blithely slyly regular express special pending "
    "final ironic even bold unusual silent fluffy ruthless idle busy daring "
    "requests deposits packages theodolites accounts foxes ideas dependencies "
    "instructions excuses platelets asymptotes courts dolphins multipliers "
    "sleep wake nag haggle dazzle detect engage integrate boost breach cajole"
).split()

# DECIMAL(12, 2) as TPC-H specifies it, at the precision the reference's
# load path (an Arrow round trip, which carries decimals as 128-bit)
# leaves it: plans built over either catalog then agree type for type
DEC2 = DECIMAL(38, 2)

# precise TPC-H comment LIKE targets (Q13 uses '%special%requests%')
_COMMENT_POOL_SIZE = 4096


def _comment_pool(rng: np.random.Generator) -> np.ndarray:
    words = rng.choice(COMMENT_WORDS, size=(_COMMENT_POOL_SIZE, 6))
    pool = np.array([" ".join(w) for w in words], dtype=object)
    # plant 'special ... requests' in ~1.2% (dbgen plants in a small fraction)
    n_special = _COMMENT_POOL_SIZE // 80
    idx = rng.choice(_COMMENT_POOL_SIZE, n_special, replace=False)
    for i in idx:
        pool[i] = "special packages wake slyly requests " + pool[i]
    return pool


def _money(rng, lo_cents: int, hi_cents: int, n: int) -> np.ndarray:
    return rng.integers(lo_cents, hi_cents + 1, n, dtype=np.int64)


def _pool_codes(pool, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dictionary codes and values of the column ``pool[idx]`` without
    building it: the values are the distinct pool strings the draws use,
    sorted, and a row's code is its value's rank among them, which is
    what ``np.unique(pool[idx].astype(str), return_inverse=True)``
    gives."""
    values, rank = np.unique(np.asarray(pool).astype(str),
                             return_inverse=True)
    drawn = np.bincount(idx, minlength=len(pool)) > 0
    used = np.zeros(len(values), dtype=bool)
    used[rank[drawn]] = True
    lut = (np.cumsum(used) - 1)[rank].astype(np.int32)
    return lut[idx], values[used]


def _complaints(planted: np.ndarray, pool, idx: np.ndarray):
    """``np.where(planted, "Customer stuff Complaints", pool[idx])`` as
    draws from the pool with that string appended."""
    return (list(pool) + ["Customer stuff Complaints"],
            np.where(planted, len(pool), idx))


def _table(name: str, schema: Schema, raw: dict, ordering=()) -> Table:
    """A table from raw columns, where a STRING column is either an
    array of strings or a ``(pool, idx)`` pair of draws from a pool."""
    cols, values = {}, {}
    for c, a in raw.items():
        if isinstance(a, tuple):
            cols[c], values[c] = _pool_codes(*a)
        elif a.dtype.kind in ("O", "U", "S"):
            v, codes = np.unique(a.astype(str), return_inverse=True)
            cols[c], values[c] = codes.astype(np.int32), v
        else:
            cols[c] = a
    return Table.from_codes(name, schema, cols, values, ordering=ordering)


def gen_tpch(sf: float = 0.01, seed: int = 19920101,
             device="cuda") -> Catalog:
    """Generate the TPC-H catalog on the host; its tables upload to
    `device` column by column when first scanned."""
    rng = np.random.default_rng(seed)
    cat = Catalog(device)
    pool = _comment_pool(rng)

    def comments(n):
        return pool, rng.integers(0, _COMMENT_POOL_SIZE, n)

    n_part = int(200_000 * sf)
    n_supp = max(10, int(10_000 * sf))
    n_cust = int(150_000 * sf)
    n_order = int(1_500_000 * sf)
    n_clerk = max(2, int(1000 * sf))

    # region / nation
    cat.add(_table(
        "region",
        Schema.of(r_regionkey=INT64, r_name=STRING, r_comment=STRING),
        {
            "r_regionkey": np.arange(5, dtype=np.int64),
            "r_name": np.array(REGIONS, dtype=object),
            "r_comment": comments(5),
        },
    ))
    cat.add(_table(
        "nation",
        Schema.of(n_nationkey=INT64, n_name=STRING, n_regionkey=INT64,
                  n_comment=STRING),
        {
            "n_nationkey": np.arange(25, dtype=np.int64),
            "n_name": np.array([n for n, _ in NATIONS], dtype=object),
            "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
            "n_comment": comments(25),
        },
    ))

    # supplier
    suppkey = np.arange(1, n_supp + 1, dtype=np.int64)
    cat.add(_table(
        "supplier",
        Schema.of(s_suppkey=INT64, s_name=STRING, s_address=STRING,
                  s_nationkey=INT64, s_phone=STRING, s_acctbal=DEC2,
                  s_comment=STRING),
        {
            "s_suppkey": suppkey,
            "s_name": np.array([f"Supplier#{k:09d}" for k in suppkey], dtype=object),
            "s_address": comments(n_supp),
            "s_nationkey": rng.integers(0, 25, n_supp, dtype=np.int64),
            "s_phone": np.array(
                [f"{10+k%25}-{k%900+100}-{k%9000+1000}" for k in suppkey],
                dtype=object,
            ),
            "s_acctbal": _money(rng, -99_999, 999_999, n_supp),
            # dbgen plants 'Customer...Complaints' in 5 per 10k suppliers (Q16)
            "s_comment": _complaints(rng.random(n_supp) < 0.0005,
                                     *comments(n_supp)),
        },
    ))

    # part
    partkey = np.arange(1, n_part + 1, dtype=np.int64)
    pname_idx = rng.integers(0, len(P_NAME_WORDS), (n_part, 5))
    p_name = np.array(
        [" ".join(P_NAME_WORDS[j] for j in row) for row in pname_idx],
        dtype=object,
    )
    mfgr = rng.integers(1, 6, n_part)
    brand = mfgr * 10 + rng.integers(1, 6, n_part)
    t1 = rng.integers(0, 6, n_part)
    t2 = rng.integers(0, 5, n_part)
    t3 = rng.integers(0, 5, n_part)
    p_type = ([f"{a} {b} {c}" for a in TYPE_SYL1 for b in TYPE_SYL2
               for c in TYPE_SYL3], (t1 * 5 + t2) * 5 + t3)
    c1 = rng.integers(0, 5, n_part)
    c2 = rng.integers(0, 8, n_part)
    container = ([f"{a} {b}" for a in CONTAINER_SYL1 for b in CONTAINER_SYL2],
                 c1 * 8 + c2)
    # dbgen retail price formula (cents): 90000 + ((pk/10)%20001) + 100*(pk%1000)
    retail = (
        90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)
    ).astype(np.int64)
    cat.add(_table(
        "part",
        Schema.of(p_partkey=INT64, p_name=STRING, p_mfgr=STRING, p_brand=STRING,
                  p_type=STRING, p_size=INT64, p_container=STRING,
                  p_retailprice=DEC2, p_comment=STRING),
        {
            "p_partkey": partkey,
            "p_name": p_name,
            "p_mfgr": ([f"Manufacturer#{m}" for m in range(6)], mfgr),
            "p_brand": ([f"Brand#{b}" for b in range(56)], brand),
            "p_type": p_type,
            "p_size": rng.integers(1, 51, n_part, dtype=np.int64),
            "p_container": container,
            "p_retailprice": retail,
            "p_comment": comments(n_part),
        },
    ))

    # partsupp: 4 suppliers per part (spec formula)
    # dbgen's stride (S/4 + (pk-1)/S) can produce duplicate suppliers per part
    # at scaled-down S; a plain S/4 stride keeps i*stride distinct mod S for
    # i in 0..3 at every scale (3*floor(S/4) < S), preserving the spec's
    # "4 distinct suppliers per part" invariant that unique-build joins rely on
    ps_stride = max(1, n_supp // 4)
    ps_partkey = np.repeat(partkey, 4)
    n_ps = len(ps_partkey)
    i = np.tile(np.arange(4), n_part)
    ps_suppkey = ((ps_partkey + i * ps_stride) % n_supp) + 1
    cat.add(_table(
        "partsupp",
        Schema.of(ps_partkey=INT64, ps_suppkey=INT64, ps_availqty=INT64,
                  ps_supplycost=DEC2, ps_comment=STRING),
        {
            "ps_partkey": ps_partkey,
            "ps_suppkey": ps_suppkey.astype(np.int64),
            "ps_availqty": rng.integers(1, 10_000, n_ps, dtype=np.int64),
            "ps_supplycost": _money(rng, 100, 100_000, n_ps),
            "ps_comment": comments(n_ps),
        },
    ))

    # customer
    custkey = np.arange(1, n_cust + 1, dtype=np.int64)
    cat.add(_table(
        "customer",
        Schema.of(c_custkey=INT64, c_name=STRING, c_address=STRING,
                  c_nationkey=INT64, c_phone=STRING, c_acctbal=DEC2,
                  c_mktsegment=STRING, c_comment=STRING),
        {
            "c_custkey": custkey,
            "c_name": np.array([f"Customer#{k:09d}" for k in custkey], dtype=object),
            "c_address": comments(n_cust),
            "c_nationkey": rng.integers(0, 25, n_cust, dtype=np.int64),
            "c_phone": np.array(
                [f"{10+k%25}-{k%900+100}-{k%9000+1000}" for k in custkey],
                dtype=object,
            ),
            "c_acctbal": _money(rng, -99_999, 999_999, n_cust),
            "c_mktsegment": (SEGMENTS, rng.integers(0, 5, n_cust)),
            "c_comment": comments(n_cust),
        },
    ))

    # orders: only customers with custkey % 3 != 0 place orders (spec)
    orderkey = np.arange(1, n_order + 1, dtype=np.int64)
    eligible = custkey[custkey % 3 != 0]
    o_custkey = eligible[rng.integers(0, len(eligible), n_order)]
    o_orderdate = rng.integers(START_DATE, END_DATE - 121, n_order).astype(np.int32)
    n_lines = rng.integers(1, 8, n_order)  # 1..7 per spec

    # lineitem (built first so orderstatus/totalprice can aggregate from it)
    l_orderkey = np.repeat(orderkey, n_lines)
    n_li = len(l_orderkey)
    l_linenumber = (
        np.arange(n_li) - np.repeat(np.cumsum(n_lines) - n_lines, n_lines) + 1
    ).astype(np.int64)
    l_partkey = rng.integers(1, n_part + 1, n_li, dtype=np.int64)
    l_suppkey = (
        (l_partkey + rng.integers(0, 4, n_li) * ps_stride) % n_supp
    ).astype(np.int64) + 1
    l_quantity = rng.integers(1, 51, n_li, dtype=np.int64) * 100  # DEC2
    l_extprice = (l_quantity // 100) * retail[l_partkey - 1]
    l_discount = rng.integers(0, 11, n_li, dtype=np.int64)  # 0.00-0.10 at DEC2
    l_tax = rng.integers(0, 9, n_li, dtype=np.int64)
    o_date_li = np.repeat(o_orderdate, n_lines).astype(np.int64)
    l_shipdate = (o_date_li + rng.integers(1, 122, n_li)).astype(np.int32)
    l_commitdate = (o_date_li + rng.integers(30, 91, n_li)).astype(np.int32)
    l_receiptdate = (l_shipdate + rng.integers(1, 31, n_li)).astype(np.int32)
    returnable = l_receiptdate <= CURRENT_DATE
    l_returnflag = (("R", "A", "N"), np.where(
        returnable, np.where(rng.random(n_li) < 0.5, 0, 1), 2))
    li_f = l_shipdate <= CURRENT_DATE
    l_linestatus = (("O", "F"), li_f.astype(np.int64))

    cat.add(_table(
        "lineitem",
        Schema.of(l_orderkey=INT64, l_partkey=INT64, l_suppkey=INT64,
                  l_linenumber=INT64, l_quantity=DEC2, l_extendedprice=DEC2,
                  l_discount=DEC2, l_tax=DEC2, l_returnflag=STRING,
                  l_linestatus=STRING, l_shipdate=DATE, l_commitdate=DATE,
                  l_receiptdate=DATE, l_shipinstruct=STRING, l_shipmode=STRING,
                  l_comment=STRING),
        {
            "l_orderkey": l_orderkey,
            "l_partkey": l_partkey,
            "l_suppkey": l_suppkey,
            "l_linenumber": l_linenumber,
            "l_quantity": l_quantity,
            "l_extendedprice": l_extprice,
            "l_discount": l_discount * 1,  # cents at scale 2 (0.00-0.10)
            "l_tax": l_tax * 1,
            "l_returnflag": l_returnflag,
            "l_linestatus": l_linestatus,
            "l_shipdate": l_shipdate,
            "l_commitdate": l_commitdate,
            "l_receiptdate": l_receiptdate,
            "l_shipinstruct": (INSTRUCTIONS, rng.integers(0, 4, n_li)),
            "l_shipmode": (SHIPMODES, rng.integers(0, 7, n_li)),
            "l_comment": comments(n_li),
        },
        # np.repeat(orderkey, n_lines) clusters the fact table by order —
        # the TPC-H physical layout; enables ordered aggregation for
        # GROUP BY l_orderkey (q18's first stage)
        ordering=("l_orderkey",),
    ))

    # orders status/totalprice from lineitems
    f_per_order = np.bincount(l_orderkey - 1, weights=li_f, minlength=n_order)
    all_f = f_per_order == n_lines
    none_f = f_per_order == 0
    o_status = (("F", "O", "P"), np.where(all_f, 0, np.where(none_f, 1, 2)))
    gross = l_extprice * (100 - l_discount) * (100 + l_tax) // 10_000
    o_total = np.bincount(
        l_orderkey - 1, weights=gross.astype(np.float64), minlength=n_order
    ).astype(np.int64)
    cat.add(_table(
        "orders",
        Schema.of(o_orderkey=INT64, o_custkey=INT64, o_orderstatus=STRING,
                  o_totalprice=DEC2, o_orderdate=DATE, o_orderpriority=STRING,
                  o_clerk=STRING, o_shippriority=INT64, o_comment=STRING),
        {
            "o_orderkey": orderkey,
            "o_custkey": o_custkey,
            "o_orderstatus": o_status,
            "o_totalprice": o_total,
            "o_orderdate": o_orderdate,
            "o_orderpriority": (PRIORITIES, rng.integers(0, 5, n_order)),
            "o_clerk": ([f"Clerk#{k:09d}" for k in range(n_clerk + 1)],
                        rng.integers(1, n_clerk + 1, n_order)),
            "o_shippriority": np.zeros(n_order, dtype=np.int64),
            "o_comment": comments(n_order),
        },
        ordering=("o_orderkey",),
    ))
    return cat


_CACHED: dict = {}


def gen_tpch_cached(sf: float, seed: int = 19920101,
                    device="cuda") -> Catalog:
    """gen_tpch memoized per process by (scale, seed, device): repeated
    harness runs (bench/load.py) share one generated catalog. The
    reference also keeps a ``.npz`` copy on disk; the port does not write
    outside the process."""
    dev = resolve_device(device)
    key = (float(sf), int(seed), str(dev))
    cat = _CACHED.get(key)
    if cat is None:
        cat = _CACHED[key] = gen_tpch(sf=sf, seed=seed, device=dev)
    return cat
