"""The metric arithmetic on synthetic runs and traces."""

import statistics

import pytest

from benchmark import trace as tr
from benchmark.harness import Run, load_module, metric_reader
from benchmark.roofline import bound_s


class _Entry:
    work_per_step = 1_000_000


def _run(steps, window):
    run = Run(_Entry())
    run.step_s = list(steps)
    run.window_s = window
    return run


def test_rate_counts_every_step_over_the_window_to_the_last_steps_end():
    # a 10 s window whose last step overran it: 6 steps of 2 s end at 12 s
    run = _run([2.0] * 6, 12.0)
    assert load_module("metrics", "msamples_per_s").read(run) == \
        pytest.approx(6 * 1.0 / 12.0)
    assert load_module("metrics", "grad_step_s").read(run) == 2.0


def test_p90_is_pythons_inclusive_decile():
    steps = [0.1 + 0.001 * i for i in range(120)]
    got = load_module("metrics", "step_p90_ms").read(_run(steps, 20.0))
    want = 1e3 * statistics.quantiles(steps, n=10, method="inclusive")[8]
    assert got == pytest.approx(want)
    assert sum(s > got / 1e3 for s in steps) >= 10


def _trace():
    t = tr.Trace(start=0.0, end=10.0)
    # overlapping and nested device intervals: busy [1, 4] and [6, 7]
    t.device = [("k_a", 1.0, 3.0), ("k_b", 2.0, 4.0), ("k_a", 2.5, 3.5),
                ("k_c", 6.0, 7.0)]
    t.host = [("aten::add", 0.0, 0.9), ("outer", 4.0, 6.0),
              ("aten::mul", 4.5, 5.5), ("tail", 7.0, 10.0)]
    return t


def test_busy_is_the_union_and_idle_the_rest():
    t = _trace()
    assert tr.busy_s(t) == pytest.approx(4.0)
    assert tr.idle_gaps(t) == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    run = Run(_Entry())
    run.trace = t
    for name in ("device_idle_pct.render", "device_idle_pct.grad"):
        assert metric_reader(name).read(run) == pytest.approx(60.0)


def test_gaps_are_labelled_by_the_innermost_host_operation():
    got = dict(tr.gaps_by_host(_trace()))
    # the gap [4, 6]: midpoint 5.0 lies in aten::mul inside outer
    assert got == {"tail": 3.0, "aten::mul": 2.0, "aten::add": 1.0}
    ops = dict(tr.device_ops(_trace()))
    assert ops["k_a"] == pytest.approx(3.0) and ops["k_b"] == 2.0


def test_launch_counts_over_wave_iterations_and_steps():
    run = Run(_Entry())
    run.trace, run.wave_iters, run.trace_steps = _trace(), 2, 4
    assert load_module("metrics", "launches_per_wave_iter").read(run) == 2.0
    assert load_module("metrics", "grad_launches_per_step").read(run) == 1.0
    assert load_module("metrics", "wave_iters_per_step").read(run) == 0.5


def test_bound_is_the_larger_of_bytes_and_operations():
    assert bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert bound_s(0, 67e12) == pytest.approx(1.0)
    assert bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
