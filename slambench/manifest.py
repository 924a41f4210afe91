"""``BENCHMARK.json`` and the files the harness finds by name in it.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, so a later change adds files and edits none:

- ``configs/<config>.json``: the configuration (the manifest's ``file``),
  whose ``"matcher"`` names its matcher;
- ``matchers/<matcher>.py``: a matcher's settings block, its parameters and
  keyword arguments for the port, its plain reference and its work;
- ``traffic/<traffic>.json``: the mix's parameters, naming its ``entry``;
- ``entries/<entry>.py``: how the program is driven (``Entry``; a ``judge``
  there replaces ``compare.judge`` for its cells);
- ``limits/<cell>.json``: the limit of each number ``compare.judge`` reads;
- ``metrics/<metric>.py``: the reader of a metric (``read(run)``);
- ``layers/<layer>.json``: the kernel-name patterns of a layer of the trace.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    def __init__(self, root: str | None = None, bench_dir: str = HERE):
        """``root`` holds BENCHMARK.json (default: the checkout, the parent of
        ``bench_dir``); ``bench_dir`` holds the named files."""
        self.bench_dir = bench_dir
        self.root = root or os.path.dirname(bench_dir)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def _json(self, *parts):
        with open(os.path.join(self.bench_dir, *parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, workload: str) -> dict:
        return self._json("limits", f"{workload}.json")

    def entry(self, name: str):
        return _load_module(os.path.join(self.bench_dir, "entries", f"{name}.py"),
                            f"slambench_entry_{name}")

    def matcher(self, name: str | None):
        """The module of the matcher a configuration's ``"matcher"`` names."""
        if name is None:
            raise KeyError('the configuration names no matcher: its file needs a "matcher" key')
        path = os.path.join(self.bench_dir, "matchers", f"{name}.py")
        if not NAME.match(str(name)) or not os.path.isfile(path):
            raise KeyError(f"no matcher {name!r}: {path} is missing")
        return _load_module(path, f"slambench_matcher_{name.replace('.', '_')}")

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        return [m for m in self.data["per_layer"] if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        return _load_module(os.path.join(self.bench_dir, "metrics", f"{metric}.py"),
                            f"slambench_metric_{metric.replace('.', '_')}")

    def layers(self) -> list[dict]:
        """Kernel layers: named ones first, then those that follow the
        preceding kernel, each group in file-name order."""
        out = []
        for path in sorted(glob.glob(os.path.join(self.bench_dir, "layers", "*.json"))):
            with open(path) as f:
                d = json.load(f)
            d["regex"] = re.compile("|".join(d["patterns"]))
            out.append(d)
        return sorted(out, key=lambda d: bool(d.get("follows_preceding")))
