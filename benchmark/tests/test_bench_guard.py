"""The import guard, and a run that finds no card."""

import subprocess
import sys

from benchmark.harness import ROOT, forbidden_modules


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["ignis_tpu_torch", "ignis_tpu_torch.api",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["ignis_tpu.api"]) == ["ignis_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client", "flax",
                              "ignis_tpu"]) == ["flax", "ignis_tpu", "jax",
                                                "jaxlib"]


def test_harness_and_reference_load_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness, benchmark.entries, benchmark.trace\n"
            "from benchmark.harness import load_module, forbidden_modules\n"
            "import benchmark.reference.pathtracer\n"
            "assert 'ignis_tpu_torch' not in sys.modules, 'reference'\n"
            "for n in ('render', 'train'): load_module('entries', n)\n"
            "for n in ('cbox', 'spd_tetra'): load_module('configs', n)\n"
            "import ignis_tpu_torch.api, ignis_tpu_torch.parallel.sharding\n"
            "print(forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return          # this test is about a machine without a card
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cbox.render",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA" in out.stderr
