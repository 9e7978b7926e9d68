"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by its name."""

import ast
import json
import os
import re

import pytest

from gbbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.benchmark()


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line_ok(w) for w in BENCH["command"])
    named = [w for w in BENCH["command"] if w.endswith(".py")]
    assert named and all(any(w.startswith(p + "/") for p in BENCH["paths"])
                         for w in named)


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(sources) == len(set(sources))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"gbbench/configs/{c['name']}.json"
        cfg = spec.config(c["name"])
        assert cfg["source"] == c["source"] and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        # every cut is a key of the file, with the published value beside it
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert cfg["reduced"][key]["published"] != cfg[key]


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and line_ok(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        for cell in m.get("workloads", cells):
            moved = next(x for x in BENCH["end_to_end"]
                         if x["name"] == m["moves"])
            assert spec.applies(moved, cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        mine = spec.cell(cell, BENCH)
        assert any(m["name"] == "setup_s" for m in mine[3])
        assert len(mine[3]) >= 2 and len(mine[4]) >= 1


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_pieces_found_by_name(cell):
    work, cfg, trf, e2e, per_layer = spec.cell(cell)
    assert cfg["name"] == work["config"]
    drv = spec.driver(trf["driver"])
    for fn in ("prepare", "trial", "check", "control"):
        assert callable(getattr(drv, fn))
    for m in e2e + per_layer:
        assert callable(spec.metric(m["name"]).read)


def test_every_metric_file_is_named():
    files = {f[:-3] for f in os.listdir(os.path.join(spec.HERE, "metrics"))
             if f.endswith(".py") and f != "__init__.py"}
    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert files == named


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert not tops & {"graphblas_tpu_torch", "graphblas_tpu", "jax",
                               "jaxlib", "flax"}, f


def test_no_file_of_the_benchmark_imports_jax():
    for base, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(base, f))}
                assert not tops & {"graphblas_tpu", "jax", "jaxlib", "flax"}
