"""TPC-C workload — the pkg/workload/tpcc analog.

Reference: pkg/workload/tpcc generates the 9-table schema and drives the
five spec transactions (NewOrder 45 / Payment 43 / OrderStatus 4 /
Delivery 4 / StockLevel 4); roachtest's tpcc check asserts the consistency
invariants (3.3.2.x: e.g. W_YTD == sum(D_YTD)). This implementation keeps
the full transaction mix and the contended district cursor, issued as
client-driven SQL TRANSACTION BLOCKS (BEGIN .. read .. write .. COMMIT
with the canonical 40001 retry loop). Reductions vs the spec, documented:
ids are flattened into single-int primary keys (the schema layer's
composite-pk reduction), character filler columns are dropped, and the
item catalog prices from a deterministic function rather than random load.

The port of ``cockroach_tpu.bench.tpcc``, unchanged: the same statements
through the port's ``Session``, whose catalog and engine live on the
session's device (the card unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import time

import numpy as np

from ..kv.txn import TransactionRetryError
from ..sql import Session

W_YTD_START = 30000_00  # cents, spec initial warehouse ytd
STOCK_START = 50  # initial s_quantity for every stock row


def _item_price_cents(i: int) -> int:
    """Deterministic item price (spec: uniform 1.00..100.00; here a fixed
    function so consistency checks can recompute totals exactly)."""
    return 100 + (i * 37) % 9900


def load(sess: Session, warehouses: int = 1, districts: int = 10,
         customers: int = 30, items: int = 100) -> None:
    """CREATE + populate the schema (ids flattened into single-int primary
    keys: district pk = w*100+d, customer pk = (w*100+d)*10000+c, stock pk
    = w*1000000+i, order pk = d_pk*1000000+o_id, order_line pk =
    o_pk*100+n, new_order pk = order pk)."""
    assert districts <= 99 and customers <= 9999 and items <= 999999, \
        "pk packing bounds: districts <= 99, customers <= 9999"
    sess.execute("""
        create table warehouse (
            w_id int primary key, w_tax decimal(4, 4),
            w_ytd decimal(12, 2))
    """)
    sess.execute("""
        create table district (
            d_pk int primary key, d_w_id int, d_id int,
            d_tax decimal(4, 4), d_ytd decimal(12, 2),
            d_next_o_id int)
    """)
    sess.execute("""
        create table customer (
            c_pk int primary key, c_w_id int, c_d_id int, c_id int,
            c_balance decimal(12, 2), c_ytd_payment decimal(12, 2),
            c_payment_cnt int, c_delivery_cnt int)
    """)
    sess.execute("""
        create table orders (
            o_pk int primary key, o_w_id int, o_d_id int, o_c_id int,
            o_ol_cnt int, o_entry_d int, o_carrier_id int,
            o_total decimal(12, 2))
    """)
    sess.execute("""
        create table new_order (no_pk int primary key, no_w_id int,
            no_d_id int)
    """)
    sess.execute("""
        create table order_line (
            ol_pk int primary key, ol_o_pk int, ol_w_id int, ol_d_id int,
            ol_number int, ol_i_id int, ol_quantity int,
            ol_amount decimal(12, 2), ol_delivery_d int)
    """)
    sess.execute("""
        create table item (i_id int primary key, i_price decimal(12, 2))
    """)
    sess.execute("""
        create table stock (
            s_pk int primary key, s_w_id int, s_i_id int, s_quantity int,
            s_ytd int, s_order_cnt int)
    """)
    irows = ", ".join(
        f"({i}, {_item_price_cents(i) / 100:.2f})"
        for i in range(1, items + 1)
    )
    sess.execute(f"insert into item values {irows}")
    for w in range(1, warehouses + 1):
        sess.execute(
            f"insert into warehouse values ({w}, 0.1000, 30000.00)")
        rows = ", ".join(
            f"({w * 100 + d}, {w}, {d}, 0.0500, 3000.00, 1)"
            for d in range(1, districts + 1)
        )
        sess.execute(f"insert into district values {rows}")
        crows = []
        for d in range(1, districts + 1):
            for c in range(1, customers + 1):
                pk = (w * 100 + d) * 10000 + c
                crows.append(f"({pk}, {w}, {d}, {c}, -10.00, 10.00, 1, 0)")
        sess.execute(f"insert into customer values {', '.join(crows)}")
        srows = ", ".join(
            f"({w * 1000000 + i}, {w}, {i}, {STOCK_START}, 0, 0)"
            for i in range(1, items + 1)
        )
        sess.execute(f"insert into stock values {srows}")


def _district(sess: Session, w: int, d: int) -> dict:
    t = sess.catalog.tables["district"]
    return t.get_row(w * 100 + d)


def _sql_txn_block(sess: Session, stmts_fn, max_retries: int = 16):
    """Issue a client-driven BEGIN..COMMIT block with the retry loop every
    CRDB client implements around 40001 (reference docs' canonical retry
    loop; the server cannot replay client-issued statements). stmts_fn
    runs the statements (it may SELECT mid-block and branch on results)."""
    for _ in range(max_retries):
        try:
            sess.execute("BEGIN")
            out = stmts_fn()
            sess.execute("COMMIT")
            return out
        except TransactionRetryError:
            if sess._txn is not None:
                sess.execute("ROLLBACK")
            continue
    raise TransactionRetryError("txn block gave up after retries")


def new_order(sess: Session, w: int, d: int, c: int, ol_cnt: int,
              entry_day: int, items: int = 100, seed: int = 0) -> int:
    """NewOrder (spec 2.4): read + bump the district cursor (THE contended
    row), insert the order, its order lines, the new_order queue entry,
    and decrement each line's stock (wrap +91 below 10, spec 2.4.2.2)."""
    dpk = w * 100 + d
    rng = np.random.default_rng((seed << 20) ^ (dpk << 8) ^ entry_day)
    line_items = [int(rng.integers(1, items + 1)) for _ in range(ol_cnt)]
    line_qty = [int(rng.integers(1, 11)) for _ in range(ol_cnt)]

    def stmts():
        r = sess.execute(
            f"select d_next_o_id from district where d_pk = {dpk}")
        o_id = int(r["d_next_o_id"][0])
        assert o_id < 1_000_000, "order id exceeds pk packing bound"
        sess.execute(
            f"update district set d_next_o_id = {o_id + 1} "
            f"where d_pk = {dpk}")
        o_pk = dpk * 1000000 + o_id
        total = 0
        lrows = []
        for n, (i_id, qty) in enumerate(zip(line_items, line_qty), 1):
            amount = _item_price_cents(i_id) * qty
            total += amount
            lrows.append(
                f"({o_pk * 100 + n}, {o_pk}, {w}, {d}, {n}, {i_id}, "
                f"{qty}, {amount / 100:.2f}, 0)"
            )
            spk = w * 1000000 + i_id
            sr = sess.execute(
                f"select s_quantity from stock where s_pk = {spk}")
            sq = int(sr["s_quantity"][0])
            nq = sq - qty if sq - qty >= 10 else sq - qty + 91
            sess.execute(
                f"update stock set s_quantity = {nq}, s_ytd = s_ytd + "
                f"{qty}, s_order_cnt = s_order_cnt + 1 where s_pk = {spk}")
        sess.execute(
            f"insert into orders values ({o_pk}, {w}, {d}, {c}, {ol_cnt}, "
            f"{entry_day}, 0, {total / 100:.2f})")
        sess.execute(f"insert into order_line values {', '.join(lrows)}")
        sess.execute(
            f"insert into new_order values ({o_pk}, {w}, {d})")
        return o_id

    return _sql_txn_block(sess, stmts)


def payment(sess: Session, w: int, d: int, c: int, amount_cents: int):
    """Payment (spec 2.5): W_YTD += h, D_YTD += h, customer balance and
    counters — three tables in ONE atomic block."""
    amt = f"{amount_cents / 100:.2f}"
    cpk = (w * 100 + d) * 10000 + c

    def stmts():
        sess.execute(
            f"update warehouse set w_ytd = w_ytd + {amt} where w_id = {w}")
        sess.execute(
            f"update district set d_ytd = d_ytd + {amt} "
            f"where d_pk = {w * 100 + d}")
        sess.execute(
            f"update customer set c_balance = c_balance - {amt}, "
            f"c_ytd_payment = c_ytd_payment + {amt}, "
            f"c_payment_cnt = c_payment_cnt + 1 where c_pk = {cpk}")

    _sql_txn_block(sess, stmts)


def order_status(sess: Session, w: int, d: int, c: int) -> dict:
    """OrderStatus (spec 2.6): read-only — customer balance + their most
    recent order and its lines."""
    cpk = (w * 100 + d) * 10000 + c

    def stmts():
        cr = sess.execute(
            f"select c_balance, c_payment_cnt from customer "
            f"where c_pk = {cpk}")
        orr = sess.execute(
            f"select max(o_pk) as m, count(*) as n from orders "
            f"where o_w_id = {w} and o_d_id = {d} and o_c_id = {c}")
        latest = None
        lines = 0
        if int(orr["n"][0]) > 0:
            o_pk = int(orr["m"][0])
            latest = o_pk % 1000000
            lr = sess.execute(
                f"select count(*) as n from order_line "
                f"where ol_o_pk = {o_pk}")
            lines = int(lr["n"][0])
        return {
            "c_balance": float(cr["c_balance"][0]),
            "c_payment_cnt": int(cr["c_payment_cnt"][0]),
            "latest_o_id": latest,
            "latest_lines": lines,
        }

    return _sql_txn_block(sess, stmts)


def delivery(sess: Session, w: int, carrier_id: int,
             delivery_day: int, districts: int = 10) -> int:
    """Delivery (spec 2.7): for each district, deliver the OLDEST undelivered
    order — pop it from the new_order queue, stamp the carrier, mark its
    order lines delivered, credit the customer the order total and bump
    their delivery count. Returns orders delivered."""

    def stmts():
        delivered = 0
        for d in range(1, districts + 1):
            nr = sess.execute(
                f"select min(no_pk) as m, count(*) as n from new_order "
                f"where no_w_id = {w} and no_d_id = {d}")
            if int(nr["n"][0]) == 0:
                continue  # spec: skipped delivery, not an error
            o_pk = int(nr["m"][0])
            sess.execute(f"delete from new_order where no_pk = {o_pk}")
            orow = sess.execute(
                f"select o_c_id, o_total from orders where o_pk = {o_pk}")
            c = int(orow["o_c_id"][0])
            total = float(orow["o_total"][0])
            sess.execute(
                f"update orders set o_carrier_id = {carrier_id} "
                f"where o_pk = {o_pk}")
            sess.execute(
                f"update order_line set ol_delivery_d = {delivery_day} "
                f"where ol_o_pk = {o_pk}")
            cpk = (w * 100 + d) * 10000 + c
            sess.execute(
                f"update customer set c_balance = c_balance + {total:.2f},"
                f" c_delivery_cnt = c_delivery_cnt + 1 "
                f"where c_pk = {cpk}")
            delivered += 1
        return delivered

    return _sql_txn_block(sess, stmts)


def stock_level(sess: Session, w: int, d: int, threshold: int = 45,
                recent: int = 20) -> int:
    """StockLevel (spec 2.8): count DISTINCT items from the district's most
    recent orders whose stock is below the threshold — the analytic read
    in the mix (order_line join stock)."""
    dpk = w * 100 + d

    def stmts():
        r = sess.execute(
            f"select d_next_o_id from district where d_pk = {dpk}")
        next_o = int(r["d_next_o_id"][0])
        lo_pk = dpk * 1000000 + max(1, next_o - recent)
        hi_pk = dpk * 1000000 + next_o
        res = sess.execute(
            f"select count(*) as n from "
            f"(select distinct ol_i_id from order_line "
            f" where ol_o_pk >= {lo_pk} and ol_o_pk < {hi_pk}) li, stock "
            f"where stock.s_i_id = li.ol_i_id and stock.s_w_id = {w} "
            f"and stock.s_quantity < {threshold}")
        return int(res["n"][0])

    return _sql_txn_block(sess, stmts)


def check_consistency(sess: Session, warehouses: int = 1,
                      districts: int = 10) -> None:
    """The tpcc 3.3.2 invariants maintained here:
    (1) W_YTD == W_YTD_START + sum of district YTD deltas;
    (2) D_NEXT_O_ID - 1 == max order id in the district == max new_order id
        when the queue is non-empty (3.3.2.3/3.3.2.4);
    (3) per order: sum(ol_amount) == o_total and count(ol) == o_ol_cnt
        (3.3.2.8 shape);
    (4) stock s_ytd == total quantity ordered of that item in that
        warehouse (conservation through NewOrder's stock updates)."""
    res = sess.execute(
        "select w_id, w_ytd from warehouse order by w_id")
    dres = sess.execute(
        "select d_w_id, sum(d_ytd) as s from district group by d_w_id "
        "order by d_w_id")
    for w_ytd, dsum in zip(res["w_ytd"], dres["s"]):
        lhs = round(float(w_ytd) * 100)
        rhs = round(W_YTD_START + (float(dsum) * 100
                                   - districts * 3000_00))
        assert lhs == rhs, f"W_YTD {lhs} != 30000.00 + district deltas {rhs}"
    per = sess.execute(
        "select o_w_id, o_d_id, max(o_pk) as m, count(*) as n "
        "from orders group by o_w_id, o_d_id")
    seen = {
        (int(wd), int(dd)): int(m) - (int(wd) * 100 + int(dd)) * 1000000
        for wd, dd, m in zip(per["o_w_id"], per["o_d_id"], per["m"])
    }
    for w in range(1, warehouses + 1):
        for d in range(1, districts + 1):
            drow = _district(sess, w, d)
            max_oid = seen.get((w, d), 0)
            assert drow["d_next_o_id"] - 1 == max_oid, (
                f"district cursor {drow['d_next_o_id']} vs max order "
                f"{max_oid}"
            )
    # (3) order totals match their lines
    ol = sess.execute(
        "select ol_o_pk, sum(ol_amount) as s, count(*) as n "
        "from order_line group by ol_o_pk")
    by_o = {int(o): (float(s), int(n))
            for o, s, n in zip(ol["ol_o_pk"], ol["s"], ol["n"])}
    orders = sess.execute(
        "select o_pk, o_total, o_ol_cnt from orders")
    for o_pk, total, cnt in zip(orders["o_pk"], orders["o_total"],
                                orders["o_ol_cnt"]):
        s, n = by_o.get(int(o_pk), (0.0, 0))
        assert n == int(cnt), f"order {o_pk}: {n} lines vs o_ol_cnt {cnt}"
        assert round(s * 100) == round(float(total) * 100), (
            f"order {o_pk}: sum(ol_amount) {s} != o_total {total}"
        )
    # (4) stock ytd conservation vs order lines
    so = sess.execute(
        "select ol_w_id, ol_i_id, sum(ol_quantity) as q from order_line "
        "group by ol_w_id, ol_i_id")
    want = {(int(w_), int(i_)): int(q)
            for w_, i_, q in zip(so["ol_w_id"], so["ol_i_id"], so["q"])}
    st = sess.execute(
        "select s_w_id, s_i_id, s_ytd from stock where s_ytd > 0")
    got = {(int(w_), int(i_)): int(y)
           for w_, i_, y in zip(st["s_w_id"], st["s_i_id"], st["s_ytd"])}
    assert got == want, f"stock s_ytd mismatch: {got} vs {want}"


def run_mix(sess: Session, txns: int = 40, warehouses: int = 1,
            districts: int = 10, customers: int = 30, items: int = 100,
            seed: int = 0) -> dict:
    """Drive the full five-transaction spec mix (NewOrder 45 / Payment 43 /
    OrderStatus 4 / Delivery 4 / StockLevel 4); returns tpmC-style
    throughput (NewOrders per minute, the spec metric)."""
    from ..utils import metric

    rng = np.random.default_rng(seed)
    new_orders = 0
    give_ups = 0
    counts = {"new_order": 0, "payment": 0, "order_status": 0,
              "delivery": 0, "stock_level": 0}
    retries0 = metric.TXN_RETRIES.value
    t0 = time.time()
    for i in range(txns):
        w = int(rng.integers(1, warehouses + 1))
        d = int(rng.integers(1, districts + 1))
        c = int(rng.integers(1, customers + 1))
        try:
            roll = rng.random()
            if roll < 0.45:
                new_order(sess, w, d, c, ol_cnt=int(rng.integers(5, 16)),
                          entry_day=20000 + i, items=items, seed=seed + i)
                new_orders += 1
                counts["new_order"] += 1
            elif roll < 0.88:
                payment(sess, w, d, c,
                        amount_cents=int(rng.integers(100, 500000)))
                counts["payment"] += 1
            elif roll < 0.92:
                order_status(sess, w, d, c)
                counts["order_status"] += 1
            elif roll < 0.96:
                delivery(sess, w, carrier_id=int(rng.integers(1, 11)),
                         delivery_day=20000 + i, districts=districts)
                counts["delivery"] += 1
            else:
                stock_level(sess, w, d)
                counts["stock_level"] += 1
        except TransactionRetryError:
            give_ups += 1  # the block exhausted its retries and was dropped
    el = time.time() - t0
    return {
        "txns": txns,
        "counts": counts,
        "new_orders": new_orders,
        "retries": int(metric.TXN_RETRIES.value - retries0),
        "give_ups": give_ups,
        "tpmC": new_orders / el * 60 if el > 0 else 0.0,
        "elapsed_s": el,
    }
