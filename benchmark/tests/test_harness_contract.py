"""The benchmark's contract on the CPU: what it may import, that cells and
metrics are found by name, the result line's schema, and that the
measurement path refuses to run without a card."""

import ast
import copy
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness, run
from benchmark.traffic import generator

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "romtime_tpu"}
#: Parts of the yardstick that take nothing of the program.
PORT_FREE = ("reference", "traffic", "roofline")
TINY = {"nx": 100, "nt": 60}


def imported_tops(path):
    """Top-level names of the absolute imports of a source file."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_port():
    for part in PORT_FREE:
        for path in (BENCH / part).rglob("*.py"):
            assert "romtime_tpu_torch" not in imported_tops(path), path
    mods = ", ".join(f"benchmark.{p}" for p in (
        "reference.assembly", "reference.sweep", "reference.compare",
        "reference.mach", "traffic.artifacts", "traffic.generator",
        "roofline.bounds"))
    code = (f"import sys; import {mods}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"romtime_tpu_torch"})


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert "romtime_tpu" not in run.forbidden_modules()
    pytest.importorskip("romtime_tpu_torch")
    import romtime_tpu_torch  # noqa: F401
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_benchmark_json_matches_its_files():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert spec["paths"] == ["benchmark"]
    for c in spec["configs"]:
        assert (REPO / c["file"]).exists()
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    for w in spec["workloads"]:
        work = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                          .read_text())
        for key in ("config", "traffic", "chips", "why"):
            assert work[key] == w[key], (w["name"], key)
        assert (BENCH / "traffic" / "mixes" / f"{w['traffic']}.json").exists()
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] == "mu_per_s"


def tiny_cell(name, root=BENCH):
    work, config, mix = harness.load_cell(name, root)
    config = copy.deepcopy(config)
    config["fom"].update(TINY)
    if config["kind"] == "fleet":
        config["cells"] = [[2, 6]] * 4 + [[3, 8]] * 2
    work = copy.deepcopy(work)
    work["check"]["limits"].update(probe_gap=1e-4, state_gap=1e-4,
                                   state_gap_median=1e-4)
    work["profile_calls"] = 1
    return work, config, dict(mix, batch=128)


def tiny_run(name, trace, root=BENCH, spec=None):
    work, config, mix = tiny_cell(name, root)
    return run.run_cell(name, work, config, mix, 3_000_000_017, 0.5, trace,
                        "cpu", time.perf_counter(), root=root, spec=spec)


@pytest.mark.parametrize("name", ["fleet-uniform-b2048",
                                  "global-n15-b2048"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(name, trace):
    pytest.importorskip("romtime_tpu_torch")
    res = tiny_run(name, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(res) == keys + ["checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] % 128 == 0 and res["attempted"] > 0
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    e2e, layer = harness.cell_metrics(spec, name)
    if trace:
        assert set(res["metrics"]) <= {m["name"] for m in layer}
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {m["name"] for m in e2e}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    """A workload file and a metric module added in a copy, with their
    BENCHMARK.json entries, run with no other edit."""
    pytest.importorskip("romtime_tpu_torch")
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    work = json.loads((root / "workloads" / "fleet-onecell-b2048.json")
                      .read_text())
    work["why"] = "a copy of the one-cell mix under another name"
    (root / "workloads" / "extra-cell.json").write_text(json.dumps(work))
    (root / "metrics" / "extra.calls.py").write_text(
        "def read(trace):\n    return float(len(trace.calls))\n")
    spec["workloads"].append(dict(name="extra-cell", config=work["config"],
                                  traffic=work["traffic"], chips=1,
                                  why=work["why"]))
    spec["per_layer"].append(dict(name="extra.calls", unit="calls",
                                  better="higher", source="host_clock",
                                  layer="router", moves="mu_per_s",
                                  workloads=["extra-cell"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    res = tiny_run("extra-cell", 1, root=root, spec=spec)
    assert res["metrics"]["extra.calls"]["value"] >= 2
    assert "route.pad_ratio" not in res["metrics"]


def test_measurement_path_refuses_without_a_card(tmp_path):
    """No card here: a run exits non-zero and prints no result, from the
    checkout and from a directory that holds only BENCHMARK.json and the
    benchmark's files."""
    argv = ["-m", "benchmark.run", "--workload", "fleet-onecell-b2048",
            "--seed", "2147483659", "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode != 0 and got.stdout.strip() == ""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    got = subprocess.run([sys.executable, *argv], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode != 0 and got.stdout.strip() == ""


def test_a_mix_key_no_generator_implements_is_refused(tmp_path):
    mix = json.loads((BENCH / "traffic" / "mixes" / "uniform-b2048.json")
                     .read_text())
    assert set(mix) <= generator.MIX_KEYS
    (tmp_path / "four-clients.json").write_text(json.dumps(dict(mix,
                                                                clients=4)))
    with pytest.raises(ValueError, match="clients"):
        generator.load_mix("four-clients", tmp_path)


@pytest.mark.parametrize("name", ["fleet-uniform-b2048",
                                  "fleet-onecell-b2048"])
def test_kept_rows_hold_each_cells_first_and_last_lane(name):
    """Every occupied cell of a call keeps its sub-batch's lanes 0 and
    n−1, beside the padding, and its drawn lanes besides."""
    from benchmark.reference.sweep import cell_of
    from benchmark.traffic.artifacts import draw_payload

    work, config, mix = harness.load_cell(name)
    config = dict(config, fom=dict(config["fom"], **TINY))
    payload = draw_payload(config, 3_000_000_019, "cpu")
    traffic = generator.Traffic(mix, config["mu_box"], 3_000_000_019)
    batch = traffic.batch(0)
    per = work["check"]["keep_per_call"]
    rows, groups = harness.keep_rows(payload, batch, per, 3_000_000_019, 0)
    cells = cell_of(payload, batch)
    assert (cells[rows] == groups).all()
    for c in np.unique(cells):
        lanes = np.nonzero(cells == c)[0]
        got = rows[groups == c]
        assert {lanes[0], lanes[-1]} <= set(got.tolist())
        assert len(got) == min(len(lanes), per + 2)
