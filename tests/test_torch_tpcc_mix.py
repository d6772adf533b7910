"""The port's TPC-C mix against the reference's on the CPU, at
tests/test_tpcc.py's sizes: the load and the seeded ``run_mix(txns=30)``
(the spec's 45/43/4/4/4 mix) through both packages' sessions, with equal
counts, new orders, retries and give-ups; then every table equal to the
reference's, row for row, and the port's state passes
``check_consistency``. The single transactions are in
``tests/test_torch_tpcc.py``."""

import pytest
import torch

from cockroach_tpu_torch.bench import tpcc
from test_torch_tpcc import SIZES, TABLES, run_both, same_table


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These small tables gain nothing from intra-op threads, and several
    test workers' thread pools on shared cores slow each other down."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _mix(mod, sess) -> dict:
    mod.load(sess, **SIZES)
    mix = mod.run_mix(sess, txns=30, **SIZES)
    return {k: mix[k] for k in ("txns", "counts", "new_orders", "retries",
                                "give_ups")}


@pytest.fixture(scope="module")
def ran():
    t, j, got, want = run_both(_mix)
    yield t, j, got, want
    t.close()
    j.close()


def test_mix_matches_reference(ran):
    _, _, got, want = ran
    assert got == want
    assert got["txns"] == 30 and got["new_orders"] > 0
    assert sum(got["counts"].values()) == 30 - got["give_ups"]
    # four of the five transactions come up in the seeded mix
    assert sum(1 for n in got["counts"].values() if n) >= 4


@pytest.mark.parametrize("table", sorted(TABLES))
def test_mix_table_equals_reference_row_for_row(ran, table):
    same_table(ran[0], ran[1], table)


def test_mix_state_is_consistent(ran):
    t, _, got, _ = ran
    tpcc.check_consistency(t, warehouses=2, districts=4)
    n = t.execute("select count(*) as n from orders")["n"][0]
    assert n == got["new_orders"]
