"""``cockroach_tpu_torch.bench.ab`` on the CPU: its usage and its failure
path. The comparison itself needs the card."""

import pytest

from cockroach_tpu_torch.bench import ab


def test_usage_without_a_checkout(capsys):
    assert ab.main([]) == 2
    assert "OTHER_CHECKOUT" in capsys.readouterr().err


def test_turn_raises_outside_a_checkout(tmp_path):
    with pytest.raises(RuntimeError, match="failed"):
        ab.turn(tmp_path)
