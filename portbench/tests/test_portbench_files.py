"""The benchmark's data files: every cell, configuration, metric reader and
kernel-class list parses, keeps to the benchmark's naming rules, and agrees
with BENCHMARK.json; a cell file added to a copy is found by name."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = H.benchmark()


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert one_line(m["layer"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_file_matches_benchmark(w):
    cell, cfg = H.load_cell(w["name"])
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    for k in ("config", "traffic", "chips", "why"):
        assert cell[k] == w[k], k
    assert one_line(w["why"]) and w["chips"] in (1, 4)
    assert (H.ROOT / "traffic" / f"{cell['kind']}.py").is_file()
    assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
    assert cfg["name"] == w["config"]


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    cfg = H.load_json(H.CHECKOUT / c["file"])
    assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
    assert (H.ROOT / "reference" / f"{cfg['reference']}.py").is_file()
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_setup_another_e2e_and_a_layer(w):
    e2e, per = H.cell_metrics(BENCH, w["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_is_reported_in_its_cells(m):
    assert (H.ROOT / "metrics" / f"{m['name']}.py").is_file()
    for cell in m["workloads"]:
        e2e, per = H.cell_metrics(BENCH, cell)
        assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)
        assert m in per


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert len(by_layer) >= 5


def test_kernel_class_files():
    rules = H.kernel_rules()
    assert {c for c, _ in rules} == {"nccl", "pytorch", "library", "hand_conv", "hand_other"}
    for p in (H.ROOT / "kernel_classes").glob("*.txt"):
        assert re.match(r"^\d+\.[a-z_]+(\.[a-z_]+)?\.txt$", p.name), p.name


def test_paths_hold_only_the_benchmark():
    for p in H.ROOT.rglob("*"):
        rel = p.relative_to(H.CHECKOUT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_a_new_cell_file_is_found_by_name(tmp_path):
    """A later cell adds a file and edits none: in a copy of the benchmark,
    a dummy cell file appears in the harness's list and loads."""
    dst = tmp_path / "portbench"
    shutil.copytree(H.ROOT, dst, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(H.CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cell = json.loads((dst / "workloads" / "resnet50.serve_b32.json").read_text())
    cell["traffic"] = "serve_b8"
    cell["params"]["batch"] = 8
    (dst / "workloads" / "resnet50.serve_b8.json").write_text(json.dumps(cell))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from portbench import harness as H; "
            "c, _ = H.load_cell('resnet50.serve_b8'); "
            "print(H.cell_names(), c['params']['batch'], H.ROOT)")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, check=True).stdout
    assert "resnet50.serve_b8" in out and " 8 " in out and str(dst) in out
