"""The span arithmetic and the readers of the program's spans, on synthetic
span logs and traces."""

import pytest

from benchmark import spans
from benchmark import trace as tr
from benchmark.harness import Run, metric_reader
from benchmark.tests.conftest import SEED, tiny

S = 1_000_000_000          # nanoseconds a second


def rec(index, name, start_s, end_s, parent=None, device_ms=None):
    return dict(index=index, name=name, start_ns=int(start_s * S),
                end_ns=int(end_s * S), parent=parent, request=0, attrs=None,
                device_ms=device_ms)


def _log():
    """Two steps in a window [0, 10] s: each a step span holding waves with
    an emit, a bounce (a traverse and a sync inside) and an accum; a
    wide-loop check (sync) between the waves."""
    out = []

    def add(name, s, e, parent=None):
        out.append(rec(len(out), name, s, e, parent))
        return len(out) - 1
    for t in (1.0, 5.0):
        step = add("step", t, t + 3.0)
        for w0 in (t + 0.5, t + 1.5):
            wave = add("wave", w0, w0 + 0.9, step)
            add("emit", w0 + 0.1, w0 + 0.2, wave)
            b = add("bounce", w0 + 0.2, w0 + 0.7, wave)
            add("traverse", w0 + 0.3, w0 + 0.4, b)
            add("sync", w0 + 0.5, w0 + 0.55, b)
            add("accum", w0 + 0.7, w0 + 0.8, wave)
        add("sync", t + 2.6, t + 2.7, step)
    return out


class _Entry:
    pass


def _run(records, monkeypatch, steps=2):
    run = Run(_Entry())
    run.trace = tr.Trace(start=0.0, end=10.0)
    run.trace_steps = steps
    monkeypatch.setattr(spans, "of_run", lambda run: spans.in_window(
        records, run.trace.start, run.trace.end) or None)
    return run


def test_self_time_is_the_span_less_its_children():
    own = spans.self_ns(_log())
    # a wave: 0.9 s less emit 0.1, bounce 0.5 and accum 0.1
    assert own[1] == pytest.approx(0.2 * S)
    # a bounce: 0.5 s less a traverse 0.1 and a sync 0.05
    assert own[3] == pytest.approx(0.35 * S)
    # children that overlap, or reach past their parent, count once
    log = [rec(0, "a", 0.0, 1.0), rec(1, "b", 0.2, 0.6, 0),
           rec(2, "c", 0.5, 0.7, 0), rec(3, "d", 0.9, 1.5, 0)]
    assert spans.self_ns(log)[0] == pytest.approx(0.4 * S)


def test_spans_outside_the_window_are_left_out():
    log = _log() + [rec(99, "step", 9.5, 10.5), rec(100, "sync", -1.0, 0.5)]
    got = spans.in_window(log, 0.0, 10.0)
    assert len(got) == len(_log())
    assert spans.in_window([dict(rec(0, "a", 1, 2), end_ns=None)], 0, 5) == []


def test_an_idle_gap_is_labelled_by_the_innermost_program_span():
    t = tr.Trace(start=0.0, end=10.0)
    # device busy but for [1.82, 1.88] (in a traverse), [2.01, 2.03] (a
    # sync), [2.42, 2.48] (the step, between waves) and [9, 10] (outside)
    t.device = [("k", 0.0, 1.82), ("k", 1.88, 2.01), ("k", 2.03, 2.42),
                ("k", 2.48, 9.0)]
    got = dict(spans.gaps_by_span(t, _log()))
    assert got == pytest.approx({"traverse": 0.06, "sync": 0.02,
                                 "step": 0.06, spans.OUTSIDE: 1.0})
    assert spans.innermost(_log(), [0.5 * S, 1.55 * S, 1.95 * S]) == [
        spans.OUTSIDE, "wave", "bounce"]


def test_the_readers_arithmetic(monkeypatch):
    run = _run(_log(), monkeypatch)
    got = {name: metric_reader(name).read(run) for name in (
        "host_syncs_per_step", "host_ms_per_step.wavefront",
        "host_ms_per_step.shading", "host_ms_per_step.traversal",
        "host_ms_per_step.sync")}
    # a step: 2 waves of a sync each, and the check between them
    assert got["host_syncs_per_step"] == 3.0
    # waves' self 0.2 s and accums 0.1 s, two of each a step
    assert got["host_ms_per_step.wavefront"] == pytest.approx(600.0)
    # bounces' self 0.35 s and emits 0.1 s
    assert got["host_ms_per_step.shading"] == pytest.approx(900.0)
    assert got["host_ms_per_step.traversal"] == pytest.approx(200.0)
    assert got["host_ms_per_step.sync"] == pytest.approx(200.0)


def _train_log():
    """Two train steps in a window [0, 10] s: forward [t, t + 1], backward
    [t + 1, t + 2], update [t + 2, t + 2.1] for t = 1 and 4."""
    log = []
    for i, t in enumerate((1.0, 4.0)):
        log += [rec(3 * i, "train.forward", t, t + 1, device_ms=30.0),
                rec(3 * i + 1, "train.backward", t + 1, t + 2,
                    device_ms=1400.0),
                rec(3 * i + 2, "train.update", t + 2, t + 2.1,
                    device_ms=0.5)]
    return log


def _launched(trace, *ops):
    """Device operations (name, launch_s, start_s, end_s) on `trace`, each
    linked to its launch by a correlation id of its own."""
    for name, launch, s, e in ops:
        corr = 100 + len(trace.launches)
        trace.launches[corr] = launch
        trace.device.append(tr.Op(name, s, e, corr))
    return trace


def _reader_ms(part, monkeypatch, *ops):
    run = _run(_train_log(), monkeypatch)
    _launched(run.trace, *ops)
    return metric_reader(f"grad_device_ms.{part}").read(run)


def test_the_train_readers_sum_the_device_intervals(monkeypatch):
    run = _run(_train_log(), monkeypatch)
    # per step: forward launches 30 ms of kernels, backward 140 ms, the
    # update 1 ms; the interval between a span's events plays no part
    for t in (1.0, 4.0):
        _launched(run.trace, ("fwd", t + 0.1, t + 0.1, t + 0.13),
                  ("bwd", t + 1.2, t + 1.2, t + 1.3),
                  ("bwd", t + 1.5, t + 1.5, t + 1.54),
                  ("upd", t + 2.05, t + 2.05, t + 2.051))
    assert metric_reader("grad_device_ms.forward").read(run) == \
        pytest.approx(30.0)
    assert metric_reader("grad_device_ms.backward").read(run) == \
        pytest.approx(140.0)
    # spans without device intervals (a run on the CPU) read nothing
    run = _run([dict(r, device_ms=None) for r in _train_log()], monkeypatch)
    assert metric_reader("grad_device_ms.backward").read(run) is None


def test_a_kernel_launched_inside_the_span_counts_after_it_closed(
        monkeypatch):
    # launched at 2.9 s inside the first backward [2, 3], run at [3.5, 3.6]
    assert _reader_ms("backward", monkeypatch,
                      ("k", 2.9, 3.5, 3.6)) == pytest.approx(50.0)
    # the same kernel is none of the forward's, though the forward holds
    # no other: no operation links to a forward span
    assert _reader_ms("forward", monkeypatch, ("k", 2.9, 3.5, 3.6)) is None


def test_a_kernel_launched_before_the_span_opened_does_not_count(
        monkeypatch):
    # launched at 1.9 s in the forward, run inside the backward's interval
    got = _reader_ms("backward", monkeypatch, ("early", 1.9, 2.2, 2.4),
                     ("k", 2.5, 2.5, 2.6))
    assert got == pytest.approx(50.0)
    assert _reader_ms("forward", monkeypatch, ("early", 1.9, 2.2, 2.4),
                      ("k", 2.5, 2.5, 2.6)) == pytest.approx(100.0)


def test_two_overlapping_kernels_count_once(monkeypatch):
    # [2.1, 2.3] and [2.2, 2.4] overlap: busy 0.3 s, not 0.4
    got = _reader_ms("backward", monkeypatch, ("a", 2.05, 2.1, 2.3),
                     ("b", 2.06, 2.2, 2.4))
    assert got == pytest.approx(150.0)


def test_a_trace_without_correlation_ids_reads_nothing(monkeypatch):
    run = _run(_train_log(), monkeypatch)
    # device operations as plain tuples, and as operations whose launch
    # the trace does not hold
    run.trace.device = [("k", 2.2, 2.4), tr.Op("k", 2.5, 2.6, 7),
                        tr.Op("k", 2.7, 2.8)]
    for part in ("forward", "backward"):
        assert metric_reader(f"grad_device_ms.{part}").read(run) is None


def test_from_profiler_on_the_cpu_has_no_device_operations():
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns() * 1e-9
        torch.ones(64).add_(1).sum()
        t1 = time.time_ns() * 1e-9
    got = tr.from_profiler(prof, t0, t1)
    assert isinstance(got, tr.Trace)
    assert got.device == [] and got.launches == {}
    assert any(name.startswith("aten::") for name, _, _ in got.host)
    assert got.window_s == pytest.approx(t1 - t0)


class _Sampler:
    def __init__(self, launches):
        self.launches = launches


def _other_readings(trace):
    """Every reading that the device trace gives but the train readers':
    the readers, the breakdown and the roofline share."""
    from benchmark.roofline import roofline_pct
    run = Run(_Entry())
    run.trace, run.trace_steps, run.wave_iters = trace, 2, 4
    got = {name: metric_reader(name).read(run) for name in (
        "launches_per_wave_iter", "grad_launches_per_step",
        "device_idle_pct.render", "device_idle_pct.grad")}
    got["busy_s"] = tr.busy_s(trace)
    got["breakdown"] = tr.breakdown(trace)
    got["gaps_by_span"] = spans.gaps_by_span(trace, _train_log())
    got["bw_roofline"] = roofline_pct(
        trace, _Sampler([{"b": 0.01}, None, {"b": 0.02}]), "bw_kernel", {},
        lambda tables, launch: launch["b"])
    return got


def test_correlation_ids_leave_every_other_reading_as_it_was():
    ops = [("bw_kernel", 1.05, 1.1, 1.3), ("fill", 1.2, 1.25, 1.5),
           ("bw_kernel", 2.1, 2.2, 2.4), ("mul", 2.5, 2.9, 3.4),
           ("bw_kernel", 4.1, 4.2, 4.3), ("mul", 5.5, 5.6, 5.9)]
    host = [("aten::mul", 0.5, 1.0), ("aten::add", 1.5, 2.1),
            ("MulBackward0", 3.4, 4.1), ("aten::where", 6.0, 9.0)]
    linked = _launched(tr.Trace(start=0.0, end=10.0, host=list(host)), *ops)
    # the same trace as the profiler's reduction gave it before it kept
    # correlation ids: plain (name, start, end) tuples and no launches
    plain = tr.Trace(start=0.0, end=10.0, host=list(host),
                     device=[(n, s, e) for n, _, s, e in ops])
    got = _other_readings(linked)
    assert got == _other_readings(plain)
    # and the numbers the reduction gave before (busy [1.1, 1.5],
    # [2.2, 2.4], [2.9, 3.4], [4.2, 4.3], [5.6, 5.9])
    assert got["busy_s"] == pytest.approx(1.5)
    assert got["device_idle_pct.grad"] == pytest.approx(85.0)
    assert got["grad_launches_per_step"] == 3.0
    assert got["launches_per_wave_iter"] == 1.5
    assert got["bw_roofline"] == pytest.approx(100.0 * 0.03 / 0.3)
    assert dict(got["breakdown"]["device_ops"]) == pytest.approx(
        {"bw_kernel": 0.5, "mul": 0.8, "fill": 0.25})
    assert dict(got["breakdown"]["idle_gaps"]) == pytest.approx(
        {"aten::where": 4.1, "host": 1.8, "aten::mul": 1.1,
         "MulBackward0": 0.8, "aten::add": 0.7})
    assert dict(got["gaps_by_span"]) == pytest.approx(
        {spans.OUTSIDE: 6.0, "train.forward": 2.0, "train.backward": 0.5})


NEW = ("host_syncs_per_step", "host_ms_per_step.wavefront",
       "host_ms_per_step.shading", "host_ms_per_step.traversal",
       "host_ms_per_step.sync", "grad_device_ms.forward",
       "grad_device_ms.backward")


@pytest.mark.parametrize("name", NEW)
def test_a_reader_without_its_spans_reads_nothing(name, monkeypatch):
    assert metric_reader(name).read(Run(_Entry())) is None   # no trace
    # no span in the window (a program that keeps none), or other spans
    assert metric_reader(name).read(_run([], monkeypatch)) is None
    other = [rec(0, "other", 1.0, 2.0)]
    got = metric_reader(name).read(_run(other, monkeypatch))
    assert got is None or (name == "host_syncs_per_step" and got == 0)


def test_program_setup_sums_the_runtimes_set_up_sections():
    from ignis_tpu_torch.utils.stats import Statistics
    st = Statistics()
    for k, dt in (("loading", 1.0), ("build_bvh", 2.0), ("upload", 0.5),
                  ("first step", 3.0), ("step", 7.0)):
        st.record(k, dt)
    run = Run(_Entry())
    run.entry.stats = st
    assert metric_reader("program_setup_s").read(run) == pytest.approx(6.5)
    # a program that times no upload: nothing
    del st.sections["upload"]
    assert metric_reader("program_setup_s").read(run) is None


@pytest.mark.parametrize("cell", ["cbox.render", "cbox.inverse"])
def test_a_traced_run_reads_its_span_metrics(cell):
    from benchmark.harness import cell_metrics, run_cell, spec_file
    wl, cfg = tiny(cell)
    r = run_cell(cell, SEED, 0.2, 1, device="cpu",
                 overrides=dict(wl, trace_seconds=0.2), config_overrides=cfg)
    assert r["correct"] is True
    want = {m["name"] for m in cell_metrics(spec_file(), cell, 1)
            if m["name"] in NEW + ("program_setup_s",)}
    # the CPU has no device interval for the train spans
    want -= {"grad_device_ms.forward", "grad_device_ms.backward"}
    assert want and want <= set(r["metrics"])


def test_a_program_without_a_span_log_reads_nothing(monkeypatch):
    from ignis_tpu_torch.utils import stats
    monkeypatch.delattr(stats, "read_spans")
    run = Run(_Entry())
    run.trace, run.trace_steps = tr.Trace(start=0.0, end=10.0), 2
    assert spans.of_run(run) is None
    assert all(metric_reader(name).read(run) is None for name in NEW)
