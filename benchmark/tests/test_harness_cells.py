"""The benchmark's catalogue: every cell, configuration, traffic mix,
driver and per-layer metric of ``BENCHMARK.json`` is found by its name, a
file dropped in is found with no other edit, names and units keep to
their characters, and nothing under ``benchmark/`` imports JAX or the JAX
package (``reference/`` nothing of the program either)."""

import ast
import json
import os
import shutil
import subprocess
import sys

import harness_support as hs
import pytest

from benchlib import catalog, harness

SPEC = json.loads((hs.CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    c = catalog.cell(cell)
    assert c["spec"]["config"] == w["config"]
    assert c["spec"]["traffic"] == w["traffic"]
    assert c["spec"]["chips"] == w["chips"] == 1
    cfg = next(x for x in SPEC["configs"] if x["name"] == w["config"])
    assert (hs.CHECKOUT / cfg["file"]) == catalog.path("configs",
                                                       w["config"], ".json")
    assert c["config"]["reduced"] == cfg["reduced"]
    assert c["config"]["source"] == cfg["source"]
    drv = catalog.module("drivers", c["traffic"]["driver"])
    e2e = {m["name"] for m in SPEC["end_to_end"] if m["name"] != "setup_s"
           and cell in m.get("workloads", CELLS)}
    names = c["spec"].get("metric_names", {})
    assert {names.get(k, k) for k in drv.END_TO_END} == e2e


def test_every_metric_has_its_reader():
    for m in SPEC["per_layer"]:
        mod = catalog.module("metrics", m["name"])
        assert mod.UNIT == m["unit"]
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    assert set(catalog.names("metrics", ".py")) == {
        m["name"] for m in SPEC["per_layer"]}


def test_every_cell_reports_what_the_contract_asks():
    for cell in CELLS:
        e2e = [m for m in SPEC["end_to_end"]
               if cell in m.get("workloads", CELLS)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def test_names_units_and_lines():
    named = [*SPEC["configs"], *SPEC["workloads"], *SPEC["end_to_end"],
             *SPEC["per_layer"]]
    for e in named:
        assert catalog.NAME.fullmatch(e["name"]), e["name"]
    for w in SPEC["workloads"]:
        assert catalog.NAME.fullmatch(w["config"])
        assert catalog.NAME.fullmatch(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in SPEC["configs"]:
        assert all(catalog.NAME.fullmatch(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200
    for m in [*SPEC["end_to_end"], *SPEC["per_layer"]]:
        assert catalog.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    names = [e["name"] for e in named]
    assert len(names) == len(set(names))
    assert len((hs.CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_new_cell_is_found_with_no_other_edit(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(hs.BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    new = dict(catalog.load("workloads", "dam1m-step"), traffic="steps100")
    (root / "workloads" / "dam1m-short.json").write_text(json.dumps(new))
    (root / "metrics" / "episodes_run.py").write_text(
        'UNIT = "episodes"\n\n\ndef read(ctx):\n'
        '    return ctx.window.get("attempted")\n')
    assert "dam1m-short" in catalog.names("workloads", ".json", root)
    cell = catalog.cell("dam1m-short", root)
    assert cell["traffic"]["episode_steps"] == 100
    rc, result = hs.run_cell("dam1m-short", trace=1, root=root)
    assert rc == 0 and result["correct"]
    assert result["metrics"]["episodes_run"]["value"] == 1


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_nothing_imports_jax_or_the_jax_package():
    for path in hs.BENCH.rglob("*.py"):
        for top, level in _imports(path):
            if level == 0:
                assert top not in harness.FORBIDDEN, (path, top)


def test_the_reference_imports_nothing_of_the_program():
    for path in (hs.BENCH / "reference").rglob("*.py"):
        for top, level in _imports(path):
            assert level > 0 or top in ("torch", "math", "__future__"), \
                (path, top)


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dam1m-step",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=hs.CHECKOUT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_run_fails_where_only_the_benchmark_is(tmp_path):
    shutil.copytree(hs.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(hs.CHECKOUT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dam1m-step",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
