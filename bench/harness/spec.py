"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file under ``bench/``. Drivers, models, references and
metric readers are Python files found the same way, so a new cell,
configuration, mix or metric is a new file and a new entry, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _entry(items, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (names may hold dots
    and dashes, which an import statement cannot)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell: its entry, its workload file, its configuration and its
    traffic, and the metrics ``BENCHMARK.json`` asks of it."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        bench = benchmark(self.root)
        self.entry = _entry(bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.entry["chips"])
        self.workload = self._json("workloads", name)
        cfg_entry = _entry(bench["configs"], self.entry["config"], "config")
        self.config = json.loads((self.root / cfg_entry["file"]).read_text())
        self.traffic = self._json("traffic", self.entry["traffic"])

        def applies(metric):
            return "workloads" not in metric or name in metric["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]

    def _json(self, folder: str, name: str) -> dict:
        return json.loads((self.root / "bench" / folder / f"{name}.json").read_text())

    def module(self, folder: str, name: str):
        return load_module(self.root / "bench" / folder / f"{name}.py",
                           f"bench_{folder}_{name}".replace("-", "_").replace(".", "_"))

    def driver(self):
        return self.module("drivers", self.workload["driver"])

    def program(self):
        return self.module("models", self.config["model"])

    def reference(self):
        return self.module("reference", self.config["model"])

    def reader(self, metric: str):
        return self.module("metrics", metric)
