"""BENCHMARK.json against the rules its readers hold it to, and each
per-layer metric's reader against its entry."""
import json
import re

import pytest

from graphbench.registry import HERE, ROOT, Registry, metrics_of

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["graphbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_configs_and_cells():
    reg = Registry()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"graphbench/configs/{c['name']}.json"
        cfg = reg.config(c["name"])
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
        reg.mix(w["traffic"])
        e2e = {m["name"] for m in metrics_of(BENCH, "end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert metrics_of(BENCH, "per_layer", w["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_agrees_with_its_entry(m):
    mod = Registry().metric(m["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"],
                                                m["moves"])
    moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
    for w in m["workloads"]:
        assert w in moved.get("workloads", [w])
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_every_metric_file_is_listed():
    listed = {m["name"] for m in BENCH["per_layer"]}
    assert {p.stem for p in (HERE / "metrics").glob("*.py")} == listed
