"""The port's tracing (`ignis_tpu_torch/utils/stats.py`): spans at the layer
boundaries of a step and of a train step, recorded only under a profiler
and on its clock, and the counter of the hot path's blocking device reads.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.convert import params_from_numpy
from ignis_tpu_torch.parallel.sharding import train_step
from ignis_tpu_torch.scene.compile import load_and_compile
from ignis_tpu_torch.scenes import demo_scene
from ignis_tpu_torch.utils import stats

FILM = 16


def _runtime(**kw):
    return Runtime(demo_scene(), width=FILM, height=FILM, seed=3,
                   device="cpu", **kw)


def _profiled(fn):
    """`fn()` under a CPU profiler, with the span log emptied first;
    returns (the profiler, the span records)."""
    stats.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, stats.read_spans()


def _iters(rt):
    rt.dumpStats()
    q = rt.stats.quantities
    return q.get("WaveIterations", 0) + q.get("TailIterations", 0)


def test_spans_record_nothing_without_a_profiler():
    rt = _runtime()
    stats.clear_spans()
    before = stats.host_syncs()
    rt.step()
    assert stats.read_spans() == []
    # the counter is always on, and the runtime shows it a step
    syncs = stats.host_syncs() - before
    assert syncs > 0 and rt.stats.quantities["HostSyncs"] == syncs
    assert "HostSyncs: " in rt.dumpStats()
    assert "upload" in rt.stats.sections


def test_a_step_is_one_span_holding_a_wave_span_per_iteration():
    rt = _runtime()
    rt.step()
    iters0, it = _iters(rt), rt.iteration
    _, recs = _profiled(rt.step)
    by_index = {r["index"]: r for r in recs}
    steps = [r for r in recs if r["name"] == "step"]
    assert len(steps) == 1 and steps[0]["request"] == it
    waves = [r for r in recs if r["name"] == "wave"]
    assert len(waves) == _iters(rt) - iters0 > 0
    assert any(w["attrs"]["tail"] for w in waves)
    assert any(not w["attrs"]["tail"] for w in waves)

    def parent(r):
        return by_index[r["parent"]]["name"]
    assert all(parent(w) == "step" for w in waves)
    for name in ("bounce", "accum"):
        got = [r for r in recs if r["name"] == name]
        assert len(got) == len(waves)
        assert all(parent(r) == "wave" for r in got)
    traverse = [r for r in recs if r["name"] == "traverse"]
    # a closest hit and a shadow ray a bounce
    assert len(traverse) == 2 * len(waves)
    assert all(parent(r) == "bounce" for r in traverse)
    assert sum(r["name"] == "emit" for r in recs) > 0
    assert {r["request"] for r in recs} == {it}
    assert all(r["start_ns"] <= r["end_ns"] for r in recs)
    assert all(r["device_ms"] is None for r in recs)


def test_spans_sit_on_the_profilers_clock():
    rt = _runtime()
    rt.step()

    def outer():
        with record_function("test.outer"):
            rt.step()
    prof, recs = _profiled(outer)
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "test.outer"]
    (step,) = [r for r in recs if r["name"] == "step"]
    assert ev.start_ns() <= step["start_ns"]
    assert step["end_ns"] <= ev.start_ns() + ev.duration_ns()


def test_sync_spans_are_the_steps_scalar_reads():
    # the stack walk: every scalar read of the step is a routed one (the
    # Baldwin-Weber kernel's plain CPU version reads its own)
    rt = _runtime(use_bvh=True)
    rt.step()
    before = stats.host_syncs()
    prof, recs = _profiled(rt.step)
    (step,) = [r for r in recs if r["name"] == "step"]
    reads = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::_local_scalar_dense"
             and step["start_ns"] <= e.start_ns() <= step["end_ns"]]
    syncs = [r for r in recs if r["name"] == "sync"]
    assert len(syncs) == len(reads) == stats.host_syncs() - before > 0


def test_tracing_leaves_the_frame_bit_equal():
    plain, traced = _runtime(), _runtime()
    plain.step()
    _profiled(traced.step)
    assert np.array_equal(plain.rawFramebuffer(), traced.rawFramebuffer())


def test_train_step_records_forward_backward_and_update_in_order():
    scene = demo_scene()
    scene["film"] = {"size": [8, 8]}
    scene["technique"] = dict(scene["technique"], max_depth=2)
    sc = load_and_compile(scene)
    tables = params_from_numpy(sc.tables, ("mat_colors", "light_data"), "cpu")
    idx = torch.arange(64, dtype=torch.int32)
    x, y = idx % 8, idx // 8
    target = torch.zeros((64, 3))
    _, recs = _profiled(lambda: train_step(sc, tables, x, y, 0, 5, 0, 1,
                                           target))
    top = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in top] == ["train.forward", "train.backward",
                                        "train.update"]
    assert all(r["request"] == 5 and r["device_ms"] is None for r in top)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(top, top[1:]))
    # the forward's render: two bounces under it
    fwd = top[0]["index"]
    assert sum(r["name"] == "bounce" for r in recs) == 2
    assert all(r["request"] == 5 for r in recs)
    waves = [r for r in recs if r["name"] == "wave"]
    assert len(waves) == 2 and all(w["parent"] == fwd for w in waves)


def test_host_item_counts_each_read_and_is_a_sync_span_when_traced():
    before = stats.host_syncs()
    assert stats.host_item(torch.tensor(7)) == 7
    assert stats.host_syncs() == before + 1
    _, recs = _profiled(lambda: stats.host_item(torch.tensor(True)))
    assert [r["name"] for r in recs] == ["sync"]
    assert stats.host_syncs() == before + 2


def test_host_tensor_counts_only_a_copy_to_the_card():
    before = stats.host_syncs()
    cpu = torch.device("cpu")
    assert stats.host_tensor((1, 2), torch.int32, cpu).tolist() == [1, 2]
    assert stats.host_tensor(3.0, torch.float32, cpu).item() == 3.0
    assert stats.host_syncs() == before


def test_self_time_leaves_out_what_the_children_cover():
    def rec(i, parent, s, e):
        return dict(index=i, name=str(i), start_ns=s, end_ns=e,
                    parent=parent, request=None, attrs=None, device_ms=None)
    outer = rec(0, None, 0, 100)
    # overlapping children [10, 40] and [30, 50], one past the end
    recs = [outer, rec(1, 0, 10, 40), rec(2, 0, 30, 50), rec(3, 0, 90, 120),
            rec(4, 1, 15, 20)]
    assert stats.self_ns(outer, recs) == 100 - 40 - 10
    assert stats.self_ns(recs[1], recs) == 30 - 5


def test_the_log_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(stats, "_LOG", stats._SpanLog(cap=3))
    with profile(activities=[ProfilerActivity.CPU]):
        with stats.span("a", {"k": 1}):
            for _ in range(4):
                with stats.span("b"):
                    pass
    recs = stats.read_spans()
    assert [r["name"] for r in recs] == ["b", "b", "b"]
    assert [r["index"] for r in recs] == [2, 3, 4]
    assert all(r["parent"] == 0 for r in recs)


@pytest.mark.cuda
def test_device_spans_read_the_cards_time():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    a = torch.randn(2048, 2048, device="cuda")
    stats.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with stats.span("mm", device=a.device):
            for _ in range(8):
                a = a @ a.T / 2048
    recs = stats.read_spans()
    assert [r["name"] for r in recs] == ["mm"], recs
    assert recs[0]["device_ms"] > 0, recs


@pytest.mark.cuda
def test_the_counted_syncs_are_those_the_sync_debug_mode_sees():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import warnings
    a = torch.ones(16, device="cuda")
    torch.cuda.synchronize()
    before = stats.host_syncs()
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            # a copy of host values to the card waits for it, as a read does
            stats.host_tensor((1, 2), torch.int32, a.device)
            assert stats.host_item(a.sum()) == 16
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode's own notice, once a process, also speaks of syncs)
    seen = [str(w.message) for w in ws
            if "called a synchronizing CUDA operation" in str(w.message)]
    assert stats.host_syncs() - before == len(seen) == 2, seen


# ------------------------------------------------------------------ media

@pytest.fixture
def one_thread():
    """One intra-op thread: a `volpath` wave is many small launches, which
    the thread pool slows, the more so beside the tier-1 run's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud_runtime(tmp_path, **kw):
    """A passthrough cube holding a seeded 12^3 NanoVDB cloud (delta
    tracking, trilinear) under a constant sky, `volpath`, 8 x 8."""
    from ignis_tpu_torch.medium.nanovdb import write_nvdb_grid
    rng = np.random.default_rng(5)
    dense = rng.uniform(0, 1, (12, 12, 12)).astype(np.float32)
    dense[dense < 0.4] = 0.0
    path = tmp_path / "cloud.nvdb"
    write_nvdb_grid(path, dense)
    scene = {
        "technique": {"type": "volpath", "max_depth": 16},
        "camera": {"type": "perspective", "fov": 40,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -4,
                                 0, 0, 0, 1]},
        "film": {"size": [8, 8]},
        "bsdfs": [{"type": "passthrough", "name": "null"}],
        "shapes": [{"type": "cube", "name": "box", "width": 2,
                    "height": 2, "depth": 2}],
        "entities": [{"name": "box", "shape": "box", "bsdf": "null",
                      "inner_medium": "cloud"}],
        "media": [{"type": "heterogeneous", "name": "cloud",
                   "filename": str(path), "scalar_density": 3.0,
                   "scalar_scattering": 0.9, "scalar_absorption": 0.1,
                   "g": 0.5, "interpolate": True,
                   "method": "delta_tracking"}],
        "lights": [{"type": "constant", "name": "sky",
                    "radiance": [0.4, 0.5, 0.7]}],
    }
    return Runtime(scene, seed=9, device="cpu", **kw)


def test_medium_spans_nest_under_bounce(tmp_path, one_thread):
    rt = _cloud_runtime(tmp_path)
    rt.step()
    _, recs = _profiled(rt.step)
    by_index = {r["index"]: r for r in recs}
    med = [r for r in recs if r["name"] == "medium"]
    bounces = [r for r in recs if r["name"] == "bounce"]
    # the coefficients and transmittance, and the distance sample and
    # event, of every bounce (NEE's transmittance too where a light is
    # sampled)
    assert len(med) >= 2 * len(bounces) > 0
    assert all(by_index[r["parent"]]["name"] == "bounce" for r in med)
    # a path step has none
    plain = _runtime()
    _, recs = _profiled(plain.step)
    assert not any(r["name"] == "medium" for r in recs)


def test_medium_events_add_up_to_the_valid_samples(tmp_path, monkeypatch,
                                                   one_thread):
    """MediumNullEvents + MediumScatters + MediumAbsorbs, added up on the
    device, equal a host count of the lanes `medium_sample` made valid."""
    from ignis_tpu_torch.render import integrator
    real = integrator.medium_sample
    valid = []

    def counted(*a, **kw):
        ms, counter = real(*a, **kw)
        valid.append(int(ms["valid"].sum()))
        return ms, counter
    monkeypatch.setattr(integrator, "medium_sample", counted)
    rt = _cloud_runtime(tmp_path)
    rt.step()
    rt.step()
    rt.dumpStats()
    q = rt.stats.quantities
    events = [q["MediumNullEvents"], q["MediumScatters"], q["MediumAbsorbs"]]
    assert events[0] > 0 and events[1] > 0
    assert sum(events) == sum(valid)
    assert q["RatioFlights"] > 0 and q["MediumLookups"] > 0
    assert "MediumNullEvents: " in rt.dumpStats()


def test_medium_counters_add_no_host_sync(tmp_path, monkeypatch, one_thread):
    """A step's host syncs are the same with the media's counters off (no
    sink), on a `volpath` and on a `path` step."""
    import ignis_tpu_torch.api as api
    import contextlib

    def syncs(make):
        rt = make()
        rt.step()
        return rt.stats.quantities["HostSyncs"]
    cloud = lambda: _cloud_runtime(tmp_path)
    counted = syncs(cloud), syncs(_runtime)
    monkeypatch.setattr(api, "medium_counts",
                        lambda sink: contextlib.nullcontext())
    assert (syncs(cloud), syncs(_runtime)) == counted
    # and the path step counts no media events at all
    rt = _runtime()
    rt.step()
    assert "MediumNullEvents" not in rt.dumpStats()


def test_sharded_step_spans_wrap_its_all_reduces(monkeypatch):
    """`sharded_train_step` on a one-rank gloo group: the four phases as
    `train_step`'s, and every `all_reduce` of the loss and the gradients
    inside the one `train.allreduce` span, which holds nothing else."""
    import torch.distributed as dist
    from ignis_tpu_torch.parallel import sharding
    scene = demo_scene()
    scene["film"] = {"size": [8, 8]}
    scene["technique"] = dict(scene["technique"], max_depth=2)
    sc = load_and_compile(scene)
    tables = params_from_numpy(sc.tables, ("mat_colors", "light_data"),
                               "cpu")
    idx = torch.arange(64, dtype=torch.int32)
    calls = []
    real = dist.all_reduce

    def recorded(t, *a, **kw):
        log = stats._LOG
        calls.append(log.open[-1].name if log.open else None)
        return real(t, *a, **kw)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        step = sharding.sharded_train_step(sc, sharding.make_mesh())
        monkeypatch.setattr(sharding.dist, "all_reduce", recorded)
        _, recs = _profiled(lambda: step(tables, idx % 8, idx // 8, 0, 5, 0,
                                         1, torch.zeros((64, 3))))
    finally:
        dist.destroy_process_group()
    top = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in top] == ["train.forward", "train.backward",
                                        "train.allreduce", "train.update"]
    assert all(r["request"] == 5 for r in top)
    # the loss and the two parameter tables' gradients
    assert calls == ["train.allreduce"] * 3
    ar = top[2]["index"]
    assert not any(r["parent"] == ar for r in recs)
