"""A mix with `fixed_work_seed`: every run seed gets the same graph and the
same requests, under other ids and in another order."""

import numpy as np
import pytest
import torch

from graphbench.conftest import last_json
from graphbench.kinds import fof
from graphbench.kinds.common import Context

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12)


@pytest.fixture
def fixed_contexts(tiny):
    _, reg = tiny
    cfg, mix = reg.config("tiny"), reg.mix("fof128-fixed")
    mix.update(pool_requests=16, warmup_requests=2)
    return [Context("t.fof-fixed", cfg, mix, s, torch.device("cpu"), False)
            for s in SEEDS]


def _unlabelled(ctx, ids):
    inverse = torch.argsort(ctx.labels())
    return inverse[torch.as_tensor(ids)]


def test_same_graph_under_other_ids(fixed_contexts):
    a, b = fixed_contexts
    (sa, da), (sb, db) = a.edges(), b.edges()
    assert not torch.equal(sa, sb)
    n = a.shape.vertices
    keys = [torch.sort(_unlabelled(c, s) * n + _unlabelled(c, d)).values
            for c, (s, d) in ((a, (sa, da)), (b, (sb, db)))]
    assert torch.equal(keys[0], keys[1])
    # the run's labels keep each destination class's in-edge count
    assert torch.equal(torch.bincount(da % 16), torch.bincount(db % 16))


def test_same_requests_in_another_order(fixed_contexts):
    pools = []
    for ctx in fixed_contexts:
        st = fof.setup(ctx)
        pools.append(_unlabelled(ctx, st.pool).numpy())
    a, b = pools
    assert not np.array_equal(a, b)
    rows = [sorted(map(tuple, p)) for p in pools]
    assert rows[0] == rows[1]


def test_fixed_cell_runs_correct(tiny, capsys):
    from graphbench import run
    bench, reg = tiny
    bench["workloads"].append({"name": "t.fof-fixed", "config": "tiny",
                               "traffic": "fof128-fixed", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "t.fof" in m.get("workloads", ()):
            m["workloads"].append("t.fof-fixed")
    for seed in SEEDS:
        rc = run.main(["--workload", "t.fof-fixed", "--seed", str(seed),
                       "--seconds", "0.3", "--trace", "0"], device="cpu",
                      registry=reg, bench=bench, loaded=lambda: [])
        out = capsys.readouterr()
        assert rc == 0, out.err[-2000:]
        res = last_json(out.out)
        assert res["correct"] is True
        assert "fof_seeds_per_s" in res["metrics"]


def test_fault_in_fixed_cell_is_not_correct(tiny, monkeypatch, capsys):
    """A count altered where it is produced turns the fixed-work cell's
    `correct` false, as it does the drawn one's."""
    import repro_torch.core as core
    from graphbench import run
    inner = core.two_hop_counts

    def faulty(*a, **kw):
        res = inner(*a, **kw)
        if res.counts.shape[0]:
            res.counts[res.counts.shape[0] // 2] += 1
        return res
    monkeypatch.setattr(core, "two_hop_counts", faulty)
    bench, reg = tiny
    bench["workloads"].append({"name": "t.fof-fixed", "config": "tiny",
                               "traffic": "fof128-fixed", "chips": 1,
                               "why": "test"})
    rc = run.main(["--workload", "t.fof-fixed", "--seed", str(SEEDS[0]),
                   "--seconds", "0.3", "--trace", "0"], device="cpu",
                  registry=reg, bench=bench, loaded=lambda: [])
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    assert last_json(out.out)["correct"] is False
