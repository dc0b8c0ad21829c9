"""Find a cell's parts by the names in BENCHMARK.json: configurations in
`configs/<name>.json`, traffic mixes in `traffic/<name>.json`, per-layer
metrics' readers in `metrics/<name>.py`, and the code that drives a kind of
traffic in `kinds/<kind>.py`. Adding a configuration, a mix of a known
kind, or a metric is adding a file; nothing here lists them."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Registry:
    def __init__(self, extra: Sequence[Path] = ()):
        """`extra`: further directories with the same layout, searched
        after this one."""
        self.dirs = [HERE, *map(Path, extra)]

    def _find(self, sub: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            p = d / sub / f"{name}{suffix}"
            if p.is_file():
                return p
        raise KeyError(f"no {sub[:-1] if sub.endswith('s') else sub} "
                       f"named {name!r} in {[str(d) for d in self.dirs]}")

    def config(self, name: str) -> dict:
        return json.loads(self._find("configs", name, ".json").read_text())

    def mix(self, name: str) -> dict:
        return json.loads(self._find("traffic", name, ".json").read_text())

    def metric(self, name: str):
        """The reader module of a per-layer metric: it defines `LAYER`,
        `UNIT`, `MOVES` and `read(readings)`, which returns a number or
        None when it finds nothing to read."""
        path = self._find("metrics", name, ".py")
        spec = importlib.util.spec_from_file_location(
            "graphbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    @staticmethod
    def kind(name: str):
        return importlib.import_module(f"graphbench.kinds.{name}")


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r}")


def metrics_of(bench: dict, section: str, cell: str) -> list:
    """The entries of `end_to_end` or `per_layer` that the cell reports:
    those whose `workloads` name it, or that have no `workloads`."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
