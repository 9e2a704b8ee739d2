"""The frozen operation and byte counts against hand counts."""
import pytest

from llcg_bench import bounds, peaks


def test_spmm_work():
    # indptr 4 x 4 B, indices + values 4 x 8 B, H read and out written
    assert bounds.spmm_csr_work(3, 4, 2) == (96.0, 16.0)


def test_sage_stack_flops():
    s = [("S", 2, 3)]
    assert bounds.sage_stack_flops(s, 4, 5, False) == 96 + 20
    assert bounds.sage_stack_flops(s, 4, 5, True) == 96 + 20 + 96
    sb = [("S", 2, 3), ("B", 3, 3)]
    assert bounds.sage_stack_flops(sb, 4, 5, True) == 212 + 96 + 96
    ss = [("S", 2, 3), ("S", 3, 1)]
    # the second layer's backward adds its input gradient and mean
    fwd2 = 2 * 4 * 3 * 1 * 2 + 2 * 5 * 3
    assert bounds.sage_stack_flops(ss, 4, 5, True) == \
        212 + fwd2 + 2 * 4 * 3 * 1 * 2 + fwd2


@pytest.mark.parametrize("nbytes, ops, want", [
    (3.35e12, 0.0, 1.0), (0.0, 67e12, 1.0), (3.35e12, 134e12, 2.0)])
def test_bound_is_the_larger_side(nbytes, ops, want):
    assert peaks.bound_seconds(nbytes, ops) == pytest.approx(want)
