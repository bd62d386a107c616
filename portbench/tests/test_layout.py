"""The benchmark's own rules: what its modules may import, and that a cell,
a configuration and a metric are found by name once their files exist."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness as H

BENCH = H.BENCH


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py")
            if "tests" not in p.relative_to(BENCH).parts]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {n.split(".")[0] for n in _top_level_imports(path)}
        assert not tops & set(H.FORBIDDEN), (path, tops & set(H.FORBIDDEN))


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        tops = {n.split(".")[0] for n in _top_level_imports(path)}
        assert tops <= {"__future__", "dataclasses", "math", "typing",
                        "numpy", "torch", "portbench"}, (path, tops)
        assert all(n.startswith("portbench.reference") for n in
                   _top_level_imports(path) if n.startswith("portbench"))


def test_forbidden_names_are_whole_top_level_names():
    assert H.forbidden_modules(["windtpu_torch", "windtpu_torch.api",
                                "torch", "jaxtyping"]) == []
    assert H.forbidden_modules(["windtpu.api", "jax.numpy",
                                "flax"]) == ["flax", "jax", "windtpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, portbench.run, portbench.control;"
            "import portbench.calibrate;"
            "from portbench import harness as H;"
            "from portbench.drivers import downscale, train, train_ranks;"
            "import windtpu_torch.api, windtpu_torch.train.loop;"
            "[H._reader(m['name'], H.BENCH) for m in "
            "H.benchmark()['per_layer']];"
            "print(H.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_every_cell_names_files_that_exist():
    bench = json.loads((H.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = H.load_cell(w["name"])
        assert cell.spec["config"] == w["config"]
        assert cell.spec["traffic"] == w["traffic"]
        assert cell.chips == w["chips"]
        assert (BENCH / "drivers" / f"{cell.driver}.py").exists()
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert callable(H._reader(m["name"], BENCH).read), m["name"]
        assert set(m["workloads"]) <= cells, m["name"]


def test_added_files_are_found_with_no_other_edit(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.loads((bench / "configs" / "flagship.json").read_text())
    cfg["model"]["generator_features"] = 64
    (bench / "configs" / "flagship_narrow.json").write_text(json.dumps(cfg))
    spec = json.loads((bench / "workloads" /
                       "flagship.train.json").read_text())
    spec["config"] = "flagship_narrow"
    (bench / "workloads" / "flagship_narrow.train.json").write_text(
        json.dumps(spec))
    (bench / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return run.units\n")
    doc = json.loads((H.ROOT / "BENCHMARK.json").read_text())
    doc["per_layer"].append(
        {"name": "steps_seen.train", "unit": "count", "better": "higher",
         "source": "program_counter", "layer": "step",
         "moves": "train_step_s", "workloads": ["flagship_narrow.train"]})
    # A new cell's entry of a kind whose reader exists needs no file.
    doc["per_layer"].append(
        {"name": "mfu.narrow", "unit": "%", "better": "higher",
         "source": "host_clock", "layer": "whole step",
         "moves": "train_step_s", "workloads": ["flagship_narrow.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = H.load_cell("flagship_narrow.train", bench)
    assert cell.config["model"]["generator_features"] == 64
    run = H.Run(cell, 7, [1.0] * 7, H.Spans(), {})
    # Only the metrics whose entries list the new cell.
    flops = cfg["model_flops"]["train_step"]
    assert H.per_layer(run, bench) == {
        "steps_seen.train": {"value": 7.0, "unit": "count"},
        "mfu.narrow": {"value": 100.0 * flops / 1.0 / 989e12, "unit": "%"}}
