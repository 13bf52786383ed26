"""Configurations, cells and metric readers are found by name, and a new
file is all a new cell needs."""

import json
import shutil

from benchmark.harness import (
    BENCH, ROOT, cell_metrics, load_json, load_module, metric_reader,
    spec_file,
)
from benchmark.tests.conftest import SEED, tiny


def test_every_name_in_the_spec_has_its_files():
    spec = spec_file()
    for c in spec["configs"]:
        cfg = load_json("configs", c["name"])
        assert (ROOT / c["file"]).is_file() and cfg["name"] == c["name"]
        assert callable(load_module("configs", c["name"]).build)
    for w in spec["workloads"]:
        wl = load_json("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["why"] == w["why"]
        assert hasattr(load_module("entries", wl["entry"]), "Cell")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(metric_reader(m["name"]).read)


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    spec = spec_file()
    for w in spec["workloads"]:
        e2e = {m["name"] for m in cell_metrics(spec, w["name"], 0)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = cell_metrics(spec, w["name"], 1)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_a_new_workload_file_adds_a_cell(cpu_cell):
    """A copy of a cell under a new name runs with no other edit."""
    name = "cbox.render_copy_for_test"
    path = BENCH / "workloads" / f"{name}.json"
    shutil.copy(BENCH / "workloads" / "cbox.render.json", path)
    try:
        assert load_json("workloads", name)["config"] == "cbox"
        from benchmark.harness import run_cell
        wl, cfg = tiny("cbox.render")
        r = run_cell(name, SEED, 0.2, 0, device="cpu", overrides=wl,
                     config_overrides=cfg)
        assert r["correct"] is True and r["attempted"] >= 1
        # a cell the spec does not list reports the metrics listing no cells
        assert {m["name"] for m in cell_metrics(spec_file(), name, 0)} == {
            "setup_s"}
    finally:
        path.unlink()


def test_workload_files_are_plain_data():
    for path in (BENCH / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        assert {"config", "entry", "chips", "why", "limits"} <= set(wl)
