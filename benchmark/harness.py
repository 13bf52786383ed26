"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload cbox.render --seed 7 --seconds 30 \
        --trace 0

Everything a cell needs is found by name: the cell in
`benchmark/workloads/<cell>.json`, its configuration in
`benchmark/configs/<config>.json` with the scene builder
`configs/<config>.py`, the module that drives its entry point in
`benchmark/entries/<entry>.py`, and each metric's reader in
`benchmark/metrics/<metric>.py`.  Which metrics a cell reports, with their
units, comes from `BENCHMARK.json`: the end-to-end metrics with `--trace 0`,
the per-layer ones with `--trace 1`.

A run: set-up (the program's own, then warming up the cell's shapes) until
the first timed step; the window, steps back to back for `--seconds`
(`--trace 1`: a shorter window under `torch.profiler`); then, with the
program's state freed, the comparison with the plain reference that
decides `correct`.  The compared numbers end standard error and the result
line, each beside its limit.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
# top-level module names that may not be loaded: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "ignis_tpu")
FAULTS = ("unchanged", "half_batch", "altered")


def forbidden_modules(modules=None):
    """The forbidden top-level names among the loaded modules, compared
    whole: `ignis_tpu_torch` is not `ignis_tpu`."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def cache_env():
    """Every kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def load_json(kind, name):
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"benchmark: no {kind[:-1]} named '{name}' ({path})")
    return json.loads(path.read_text())


def load_module(kind, name):
    """`benchmark/<kind>/<name>.py` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"benchmark: no {kind} module '{name}' ({path})")
    mod_name = f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec_file():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(spec, cell, trace):
    """The metrics a cell reports: the end-to-end entries of BENCHMARK.json
    (`trace` 0) that list the cell or list no cells, or the per-layer ones
    (`trace` 1) that list it."""
    if trace:
        return [m for m in spec["per_layer"] if cell in m["workloads"]]
    return [m for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def metric_reader(name):
    """`metrics/<name>.py`, or, where there is none, the reader named by
    the part before the first dot (`device_idle_pct.grad` is read by
    `device_idle_pct.py`)."""
    if not (BENCH / "metrics" / f"{name}.py").is_file():
        name = name.split(".", 1)[0]
    return load_module("metrics", name)


def finite_or_text(value):
    """A number for the result line: JSON has no NaN or infinity."""
    return value if math.isfinite(value) else repr(float(value))


class Run:
    """What a run measured, for the metric readers."""

    def __init__(self, entry):
        self.entry = entry
        self.setup_s = None
        self.step_s = []
        self.window_s = None
        self.peak_bytes = 0
        self.trace = None
        self.trace_steps = 0
        self.wave_iters = None
        self.sampler = None

    @property
    def steps(self):
        return len(self.step_s)


def run_cell(cell, seed, seconds, trace, device="cuda", overrides=None,
             config_overrides=None, fault=None, control=False,
             t_process=None):
    """Run one cell once; returns the result dict (without printing).
    `overrides` and `config_overrides` replace keys of the workload and of
    its configuration (tests run tiny cells on the CPU); `fault` breaks the
    timed path (tests of the check); `control` puts the lower-precision
    reference in the program's place in the comparison."""
    import torch
    t_process = time.perf_counter() if t_process is None else t_process
    wl = dict(load_json("workloads", cell), **(overrides or {}))
    cfg = dict(load_json("configs", wl["config"]),
               **(config_overrides or {}))
    builder = load_module("configs", wl["config"])
    entry = load_module("entries", wl["entry"]).Cell(
        wl, cfg, builder, int(seed), torch.device(device))
    run = Run(entry)
    spec = spec_file()
    metrics = cell_metrics(spec, cell, trace)

    entry.setup()
    if fault:
        entry.break_path(fault)
    cuda = entry.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the reference's own work at set-up (an inverse job's target) is not
    # the program's set-up
    run.setup_s = (time.perf_counter() - t_process
                   - getattr(entry, "reference_s", 0.0))
    work0 = entry.work()
    if trace:
        _traced_window(torch, run, wl, seconds)
    else:
        _window(run, seconds)
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated()
    work = {k: v - work0[k] for k, v in entry.work().items()}
    out = {}
    for m in metrics:
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    gpu = entry.device.type == "cuda"
    device = {"platform": "gpu" if gpu else "cpu",
              "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
              "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": None, "attempted": run.steps, "failed": 0,
              "metrics": out, "device": device, "step_s": run.step_s,
              "work": work}
    if trace:
        from benchmark import trace as tr_mod
        result["device"]["busy_s"] = tr_mod.busy_s(run.trace)
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = tr_mod.breakdown(run.trace)
    # the sampled launches hold device tensors: free them before the check
    run.sampler = run.trace = None
    gc.collect()
    t_check = time.perf_counter()
    checks = entry.check(control=control)
    entry.restore()
    print(f"benchmark: set-up {run.setup_s:.3f} s, window {run.window_s:.3f} s"
          f" ({run.steps} steps), check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    result["correct"] = all(math.isfinite(c["value"])
                            and c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = {k: {"value": finite_or_text(c["value"]),
                            "limit": c["limit"]} for k, c in checks.items()}
    return result


def _window(run, seconds, mark=contextlib.nullcontext):
    """Steps back to back until `seconds` have passed, each in `mark()`;
    the window ends with the step that passes them."""
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        with mark():
            run.entry.step()
        b = time.perf_counter()
        run.step_s.append(b - a)
        if b - t0 >= seconds:
            break
    run.window_s = b - t0


def _traced_window(torch, run, wl, seconds):
    """A window of at most `trace_seconds` under the profiler, with the
    cell's traversal launches sampled for the rooflines."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from benchmark import trace as tr_mod
    entry = run.entry
    length = min(float(seconds), float(wl.get("trace_seconds", seconds)))
    acts = [ProfilerActivity.CPU]
    if entry.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    run.sampler = entry.launch_sampler()
    w0 = entry.work()
    with profile(activities=acts) as prof:
        with run.sampler:
            t_start = time.time_ns() * 1e-9
            _window(run, length, lambda: record_function("benchmark.step"))
            t_end = time.time_ns() * 1e-9
    run.trace_steps = run.steps
    w1 = entry.work()
    # iterations of the wavefront loop, full-width and tail
    run.wave_iters = sum(w1.get(k, 0) - w0.get(k, 0)
                         for k in ("wave_iters", "tail_iters"))
    run.trace = tr_mod.from_profiler(prof, t_start, t_end)
    run.trace.device = [e for e in run.trace.device
                        if t_start <= e[1] <= t_end]


def main(argv=None, t_process=None):
    t_process = time.perf_counter() if t_process is None else t_process
    cache_env()
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="compare the lower-precision reference in the "
                         "program's place (the check's control)")
    ap.add_argument("--fault", choices=FAULTS, default=None,
                    help="break the timed path (to read a fault)")
    args = ap.parse_args(argv)
    wl = load_json("workloads", args.workload)
    import torch
    need = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: cell '{args.workload}' needs {need} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      fault=args.fault, control=bool(args.control),
                      t_process=t_process)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
