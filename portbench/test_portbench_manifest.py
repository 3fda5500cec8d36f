"""BENCHMARK.json against the contract's shape rules, and the harness
finding every cell's files and every metric's reader by name."""
import importlib
import json
import os
import re
import shutil

import pytest

from portbench import harness, smoke

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_names_units_and_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in man["end_to_end"])
    for w in man["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
    assert len(json.dumps(man)) < 64 * 1024


def test_every_layer_metric_moves_a_metric_its_cells_report(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
    for cell in cells:  # each cell: setup_s, one more end-to-end, one per-layer metric
        assert len(harness.cell_metrics(man, cell, False)) >= 2
        assert harness.cell_metrics(man, cell, True)


def test_cells_find_their_files_and_readers(man):
    for w in man["workloads"]:
        _, config, traffic, limits = harness.cell_files(man, w["name"])
        assert config["name"] == w["config"] and limits
        importlib.import_module(f"portbench.drivers.{config['driver']}")
    for c in man["configs"]:
        assert c["file"].startswith("portbench/configs/") and len(c["reduced"]) <= 16
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_a_new_traffic_file_and_entry_need_no_other_edit(tmp_path):
    """A mix added as a data file plus a workloads entry runs, with its
    own rate, through the unchanged harness."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT + "/portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.manifest()
    with open(os.path.join(harness.HERE, "traffic", "s8-poisson.json")) as f:
        mix = dict(json.load(f), rate_per_s=2.5)
    (root / "portbench" / "traffic" / "s8-slow.json").write_text(json.dumps(mix))
    shutil.copy(root / "portbench" / "checks" / "vggt1b-s8-poisson.json",
                root / "portbench" / "checks" / "vggt1b-s8-slow.json")
    man["workloads"].append({"name": "vggt1b-s8-slow", "config": "vggt-1b",
                             "traffic": "s8-slow", "chips": 1, "why": "a slower mix"})
    man["end_to_end"][0]["workloads"].append("vggt1b-s8-slow")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    run, line = smoke.run("vggt1b-s8-slow", root=str(root))
    assert run.traffic["rate_per_s"] == 2.5 and len(run.requests) == 2
    assert line["correct"] and line["attempted"] == len(run.requests) > 0
    assert set(line["metrics"]) == {"scene_p95_ms", "setup_s"}
