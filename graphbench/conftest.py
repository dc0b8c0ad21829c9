"""Fixtures of graphbench's tests: a tiny configuration and cells, written
to a temporary directory that the registry searches after its own."""
import copy
import json

import pytest

from graphbench.registry import HERE, Registry, load_benchmark


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips where torch sees none")


TINY = {"vertices": 3000, "edges": 42000}


@pytest.fixture
def tiny(tmp_path):
    """(bench, registry): BENCHMARK.json with the cells `t.fof` and
    `t.pagerank` of a 3,000-vertex cut of soc-livejournal1 added, every
    metric of the real fof / PageRank cells reported in them."""
    cfg = json.loads((HERE / "configs" / "soc-livejournal1.json")
                     .read_text())
    cfg.update(name="tiny", **TINY)
    cfg["assumed"].update(max_out_degree=60, max_in_degree=40)
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench = copy.deepcopy(load_benchmark())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "-", "reduced": [], "why": "test"})
    bench["workloads"] += [
        {"name": "t.fof", "config": "tiny", "traffic": "fof128", "chips": 1,
         "why": "test"},
        {"name": "t.pagerank", "config": "tiny", "traffic": "pagerank5",
         "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        ws = m.get("workloads")
        if ws is None:
            continue
        if any(w.endswith(".fof") for w in ws):
            ws.append("t.fof")
        if any(w.endswith(".pagerank") for w in ws):
            ws.append("t.pagerank")
    return bench, Registry([tmp_path])


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
