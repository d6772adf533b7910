"""The port's TPC-C (cockroach_tpu_torch/bench/tpcc.py) against the
reference's (cockroach_tpu/bench/tpcc.py) on the CPU, at
tests/test_tpcc.py's sizes (2 warehouses, 4 districts, 6 customers, 20
items): the load and each of the five transactions run through both
packages' sessions, with equal return values; then every table the load
creates (the reduction keeps eight of the spec's nine: it has no history
table) equal to the reference's, row for row, and the port's state
passes ``check_consistency``. ``tests/test_torch_tpcc_mix.py`` does the
same for the seeded ``run_mix(txns=30)``: the reference's compiles take
most of a minute for each half."""

import threading

import numpy as np
import pytest
import torch

from cockroach_tpu.bench import tpcc as jtpcc
from cockroach_tpu.sql import Session as jSession
from cockroach_tpu_torch.bench import tpcc
from cockroach_tpu_torch.sql import Session

SIZES = {"warehouses": 2, "districts": 4, "customers": 6, "items": 20}
TABLES = {"warehouse": "w_id", "district": "d_pk", "customer": "c_pk",
          "orders": "o_pk", "new_order": "no_pk", "order_line": "ol_pk",
          "item": "i_id", "stock": "s_pk"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tables gain nothing from intra-op threads, and several
    test workers' thread pools on shared cores slow each other down."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _scenario(mod, sess) -> dict:
    """Each transaction; what each returned."""
    mod.load(sess, **SIZES)
    out = {"new_order": [
        mod.new_order(sess, 1, 2, 3, ol_cnt=5, entry_day=20000, items=20),
        mod.new_order(sess, 1, 2, 3, ol_cnt=7, entry_day=20001, items=20)]}
    mod.payment(sess, 1, 2, 3, amount_cents=1234)
    out["order_status"] = mod.order_status(sess, 1, 2, 3)
    out["delivery"] = mod.delivery(sess, 1, carrier_id=7,
                                   delivery_day=20020, districts=4)
    out["stock_level"] = mod.stock_level(
        sess, 1, 2, threshold=mod.STOCK_START + 100)
    return out


def run_both(scenario):
    """`scenario` through the port on a thread of its own while the
    reference runs here: the reference's XLA compiles leave the
    interpreter free for most of its time."""
    t = Session(val_width=256, device="cpu")
    j = jSession(val_width=256)
    got: list = []
    th = threading.Thread(target=lambda: got.append(scenario(tpcc, t)))
    th.start()
    try:
        want = scenario(jtpcc, j)
    finally:
        th.join(timeout=300)
    assert not th.is_alive() and len(got) == 1
    return t, j, got[0], want


@pytest.fixture(scope="module")
def ran():
    t, j, got, want = run_both(_scenario)
    yield t, j, got, want
    t.close()
    j.close()


def test_transactions_return_what_the_reference_returns(ran):
    _, _, got, want = ran
    assert got["new_order"] == want["new_order"] == [1, 2]
    assert got["order_status"] == want["order_status"]
    assert got["order_status"]["latest_o_id"] == 2
    assert got["order_status"]["latest_lines"] == 7
    # district (1, 2) holds warehouse 1's only undelivered orders
    assert got["delivery"] == want["delivery"] == 1
    # every item ordered is below a threshold above the start quantity
    assert got["stock_level"] == want["stock_level"] > 0


def same_table(t, j, table) -> None:
    q = f"select * from {table} order by {TABLES[table]}"
    got, want = t.execute(q), j.execute(q)
    assert list(got) == list(want)
    assert len(got[TABLES[table]]) > 0
    for name in got:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]),
                                      err_msg=f"{table}.{name}")


@pytest.mark.parametrize("table", sorted(TABLES))
def test_table_equals_reference_row_for_row(ran, table):
    same_table(ran[0], ran[1], table)


def test_port_state_is_consistent(ran):
    t = ran[0]
    tpcc.check_consistency(t, warehouses=2, districts=4)
    n = t.execute("select count(*) as n from orders")["n"][0]
    assert n == 2
