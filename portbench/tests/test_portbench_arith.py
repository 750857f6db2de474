"""The window's arithmetic on synthetic timelines: whole-batch rates."""
import pytest

from portbench import harness


def test_whole_batch_rate_counts_batches_that_finished_inside():
    ends = [2.0, 4.0, 6.0, 8.0, 10.5]  # the last finishes past the 10 s window
    rate, n = harness.whole_batch_rate(0.0, ends, [64] * 5, 10.0)
    assert (rate, n) == (pytest.approx(4 * 64 / 8.0), 4)


def test_a_stall_inside_the_window_lowers_the_rate():
    steady, _ = harness.whole_batch_rate(0.0, [2.0, 4.0, 6.0, 8.0], [64] * 4, 10.0)
    stalled, n = harness.whole_batch_rate(0.0, [2.0, 4.0, 9.0, 11.0], [64] * 4, 10.0)
    assert n == 3 and stalled == pytest.approx(3 * 64 / 9.0) and stalled < steady


def test_no_batch_inside_the_window():
    assert harness.whole_batch_rate(0.0, [12.0], [64], 10.0) == (None, 0)
