"""The live cell's parts on the CPU, at a tiny size of their own: the
`live_fof` kind end to end through `run.main`, `reference/live.py` against
a plain Python set replay, and faults planted in the served path, each of
which has to turn `correct` false through the check that covers it."""
import copy
import json

import numpy as np
import pytest
import torch

from graphbench import run
from graphbench.conftest import last_json
from graphbench.reference import live
from graphbench.registry import HERE, Registry, load_benchmark

RUN = ["--seed", str(2 ** 31 + 11), "--seconds", "0.4"]
CELL = "t.live-fof"


@pytest.fixture
def tiny_live(tmp_path):
    """(bench, registry): BENCHMARK.json with the cell `t.live-fof` of a
    3,000-vertex cut of soc-livejournal1-live added, with a store and a mix
    cut to match, and every metric of lj.live-fof reported in it."""
    cfg = json.loads((HERE / "configs" / "soc-livejournal1-live.json")
                     .read_text())
    cfg.update(name="tiny-live", vertices=3000, edges=42000)
    cfg["assumed"].update(max_out_degree=60, max_in_degree=40)
    cfg["store"].update(buffer_cap=1000, max_partition_edges=4000,
                        persist_min_edges=256)
    mix = json.loads((HERE / "traffic" / "live-fof128.json").read_text())
    mix.update(pool_requests=16, warmup_requests=2, checked_requests=4,
               aging_writes=2700)
    for sub, name, doc in (("configs", "tiny-live", cfg),
                           ("traffic", "live-tiny", mix)):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / f"{name}.json").write_text(json.dumps(doc))
    bench = copy.deepcopy(load_benchmark())
    bench["configs"].append({"name": "tiny-live", "source": "test",
                             "file": "-", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-live",
                               "traffic": "live-tiny", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lj.live-fof" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return bench, Registry([tmp_path])


def drive(bench, reg, trace, capsys):
    rc = run.main(["--workload", CELL, *RUN, "--trace", str(trace)],
                  device="cpu", registry=reg, bench=bench,
                  loaded=lambda: [])
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    return last_json(out.out), out.err


@pytest.mark.parametrize("trace", [0, 1])
def test_the_live_cell_end_to_end(tiny_live, trace, capsys):
    bench, reg = tiny_live
    res, err = drive(bench, reg, trace, capsys)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) >= {
        "seeds_wrong", "edges_differing", "times_differing",
        "reopened_edges_differing", "reopened_times_differing",
        "writes_missed"}
    m = res["metrics"]
    if trace:
        assert {"setup.store_build_s", "setup.plan_build_s",
                "setup.aging_s", "multihop.host_ms"} <= set(m)
        assert m["live.base_builds"]["value"] == 0
        assert m["live.delta_edges"]["value"] > 0
        assert m["live.delta_ms"]["value"] > 0
        assert m["live.write_ms"]["value"] > 0
    else:
        assert {"setup_s", "fof_seeds_per_s"} <= set(m)
    assert "set-up aging" in err and "base builds 0" in err
    assert "reopened copy: 0 keys and 0 times differing" in err


def test_the_written_times_replay_copy_by_copy():
    """Inserts add a copy, an update sets the newest copy's time (a
    generated copy's where no insert came since), a delete drops every
    copy, an update of an absent key does nothing."""
    base = torch.tensor([10, 20])
    log = [(10, 0, 100), (20, 1, 101), (20, 0, 102), (30, 1, 103),
           (30, 1, 104), (30, 0, 105), (40, 0, 106), (20, -1, -1),
           (20, 1, 107), (50, 1, 108), (50, -1, -1)]
    k, c, t = (torch.tensor(x) for x in zip(*log))
    got = live.written_times(base, k, c.to(torch.int8), t, len(log))
    assert list(zip(*(x.tolist() for x in got))) == [
        (10, 100), (20, 107), (30, 103), (30, 105)]
    got = live.written_times(base, k, c.to(torch.int8), t, 3)
    assert list(zip(*(x.tolist() for x in got))) == [(10, 100), (20, 102)]
    pk, pt = torch.tensor([1, 1, 2]), torch.tensor([5, 5, 6])
    assert live.pairs_differing(pk, pt, pk, pt) == 0
    assert live.pairs_differing(pk, pt, pk[1:], pt[1:]) == 1
    assert live.pairs_differing(pk, pt, torch.tensor([1, 2]),
                                torch.tensor([5, 7])) == 3


def test_the_reference_replays_as_a_python_set():
    rng = np.random.default_rng(3)
    n = 50
    base = np.unique(rng.integers(0, n * n, 300))
    keys = rng.integers(0, n * n, 400)
    keys[::3] = base[rng.integers(0, base.shape[0], keys[::3].shape[0])]
    kind = rng.choice([1, 0, -1], 400).astype(np.int8)
    t = (torch.from_numpy(base), torch.from_numpy(keys),
         torch.from_numpy(kind))
    for upto in (0, 1, 57, 200, 400):
        want = set(base.tolist())
        for k, c in zip(keys[:upto].tolist(), kind[:upto].tolist()):
            if c == 1:
                want.add(k)
            elif c == -1:
                want.discard(k)
        got = live.key_set(*t, upto)
        assert got.tolist() == sorted(want)
        assert live.keys_differing(torch.cat([got, got[:5]]), got) == 0
        idx = live.edge_index(got, n)
        for v in (0, 7, n - 1):
            heads = idx.heads[idx.ptr[v]:idx.ptr[v + 1]].tolist()
            assert heads == sorted(k % n for k in want if k // n == v)
    assert live.keys_differing(torch.tensor([1, 2, 3]),
                               torch.tensor([2, 3, 4, 5])) == 3


def test_answers_without_the_delta_are_caught(tiny_live, capsys,
                                              monkeypatch):
    """Dense hops on the base plan alone, the writes since it was built
    left out: `seeds_wrong` turns `correct` false."""
    from repro_torch.core import multihop
    monkeypatch.setattr(multihop, "_apply_delta", lambda *a: None)
    res, _ = drive(*tiny_live, 0, capsys)
    assert res["correct"] is False
    assert res["checks"]["seeds_wrong"]["value"] > 0


def test_a_lost_write_is_caught(tiny_live, capsys, monkeypatch):
    """An insert acknowledged but never applied to the store (its last
    link dropped): `edges_differing` turns `correct` false."""
    from repro_torch.core import ServiceDB
    inner = ServiceDB.insert_edges

    def lossy(self, src, dst, etype=None, columns=None):
        columns = {k: v[:-1] for k, v in (columns or {}).items()}
        return inner(self, src[:-1], dst[:-1], columns=columns)
    monkeypatch.setattr(ServiceDB, "insert_edges", lossy)
    res, _ = drive(*tiny_live, 0, capsys)
    assert res["correct"] is False
    assert res["checks"]["edges_differing"]["value"] > 0


def test_a_lost_update_is_caught(tiny_live, capsys, monkeypatch):
    """A column update acknowledged but never applied: `times_differing`
    turns `correct` false, on the live view and the reopened copy alike,
    while every key set still agrees."""
    from repro_torch.core import ServiceDB
    monkeypatch.setattr(ServiceDB, "update_edge_column",
                        lambda self, *a: True)
    res, _ = drive(*tiny_live, 0, capsys)
    checks = res["checks"]
    assert res["correct"] is False
    assert checks["times_differing"]["value"] > 0
    assert checks["reopened_times_differing"]["value"] > 0
    assert checks["edges_differing"]["value"] == 0
    assert checks["seeds_wrong"]["value"] == 0


@pytest.mark.parametrize("record, check", [
    ("append_inserts", "reopened_edges_differing"),
    ("append_column", "reopened_times_differing"),
    ("append_delete", "reopened_edges_differing")])
def test_a_skipped_wal_append_is_caught(tiny_live, capsys, monkeypatch,
                                        record, check):
    """Writes applied in memory whose WAL records are never written: the
    live view reads them back, but the store's files, reopened as after a
    process crash, lack them, and `correct` turns false."""
    from repro_torch.core.walog import SegmentedWAL
    monkeypatch.setattr(SegmentedWAL, record, lambda self, *a, **kw: None)
    res, _ = drive(*tiny_live, 0, capsys)
    checks = res["checks"]
    assert res["correct"] is False
    assert checks[check]["value"] > 0
    assert checks["edges_differing"]["value"] == 0
    assert checks["times_differing"]["value"] == 0
