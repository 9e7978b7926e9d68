"""Finds every piece of a cell by its name in ``BENCHMARK.json``."""

import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config(name):
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name):
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def driver(name):
    return importlib.import_module(f"{__package__}.drivers.{name}")


def metric(name):
    """The reader of a metric: ``metrics/<name>.py``, loaded by its path,
    since a metric's name may hold dots."""
    key = name.replace(".", "_dot_").replace("-", "_dash_")
    mod_name = f"{__package__}.metrics.{key}"
    if mod_name not in sys.modules:
        path = os.path.join(HERE, "metrics", f"{name}.py")
        found = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(found)
        sys.modules[mod_name] = mod
        found.loader.exec_module(mod)
    return sys.modules[mod_name]


def applies(metric_entry, cell_name):
    return cell_name in metric_entry.get("workloads", [cell_name])


def cell(name, bench=None):
    """The cell's workload entry, configuration, traffic and metric
    entries: (workload, config, traffic, end_to_end, per_layer)."""
    bench = benchmark() if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    return (w, config(w["config"]), traffic(w["traffic"]),
            [m for m in bench["end_to_end"] if applies(m, name)],
            [m for m in bench["per_layer"] if applies(m, name)])
