"""The port's dry-run (repro_torch/launch/dryrun.py): each cell's step run
once on meta DTensors over a `fake` process group, its record against the
reference's (repro/launch/dryrun.py).

Held here: the record has the reference's keys (read from the reference's
`run_cell` source); one DTensor matmul whose collective is known gives
exactly one all-gather of the gathered shard's bytes and the local
product's FLOPs; smoke-config cells of each family run to status "ok" on
fake worlds of 8 (2 x 4 and 2 x 2 x 2, the production meshes' axis names);
EquiformerV2's psw_ring cell counts the ring's hops as
collective-permutes of the shards' bytes, and a MoE cell replicates no
routing op (each device routes its own groups); the CLI writes a record,
a skipped cell says why, and a cell that reaches an op with no meta form
records "error" with the op named. The process group is destroyed after
each test."""
import ast
import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import dryrun as ref_dryrun
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def world():
    import torch.distributed as dist
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def reference_record_keys():
    """The keys of the reference's `run_cell` record, from its source."""
    tree = ast.parse(inspect.getsource(ref_dryrun.run_cell))
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
    return keys


MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}


def test_reference_keys_are_read():
    keys = reference_record_keys()
    assert {"flops_per_device", "collective_bytes_by_kind", "memory",
            "hlo_size_chars", "status"} <= keys
    assert MEMORY_KEYS <= keys


def test_one_matmul_gives_one_all_gather_of_known_bytes(world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dryrun._init_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    x = distribute_tensor(torch.empty((64, 32), device="meta"), mesh,
                          (Shard(0), Replicate()), src_data_rank=None)
    w = distribute_tensor(torch.empty((32, 16), device="meta"), mesh,
                          (Shard(0), Shard(1)), src_data_rank=None)
    with dryrun.CollectiveCounter() as counter:
        y = x @ w
    assert y.placements == (Shard(0), Shard(1))
    # w's rows gathered over `data`: the local (32, 16 / 4) fp32 shard
    assert dict(counter.counts) == {"all-gather": 1}
    assert dict(counter.bytes_by_kind) == {"all-gather": 32 * 4 * 4}
    # the local product: (64 / 2) x 32 x (16 / 4), 2 FLOPs a term
    assert counter.flops == 2 * 32 * 32 * 4


CELLS = [("granite-3-2b", "train_4k", "single", (2, 4)),
         ("granite-3-2b", "train_4k", "multi", (2, 2, 2)),
         ("granite-3-2b", "decode_32k", "single", (2, 4)),
         ("qwen3-moe-235b-a22b", "prefill_32k", "single", (2, 4)),
         ("bert4rec", "serve_p99", "single", (2, 4)),
         ("gin-tu", "ogb_products", "single", (2, 4)),
         ("meshgraphnet", "full_graph_sm", "single", (2, 4)),
         ("equiformer-v2", "molecule", "single", (2, 4)),
         ("equiformer-v2", "minibatch_lg", "single", (2, 4))]
# the MoE routing's ops: none may run replicated
ROUTING_OPS = {"aten.searchsorted.Tensor", "aten.sort.stable",
               "aten.topk.default", "aten.scatter.src",
               "aten.gather.default", "aten.index.Tensor"}


@pytest.mark.parametrize("arch,shape,kind,mesh_shape", CELLS)
def test_smoke_cells_run_with_the_reference_record(world, arch, shape, kind,
                                                   mesh_shape):
    rec = dryrun.run_cell(arch, shape, kind, config="smoke",
                          mesh_shape=mesh_shape)
    assert rec["status"] == "ok", rec
    keys = reference_record_keys() - MEMORY_KEYS
    assert keys <= set(rec) | {"skip_reason"}, keys - set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["n_devices"] == 8
    assert rec["flops_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["collective_bytes_per_device"] == sum(
        rec["collective_bytes_by_kind"].values())
    assert set(rec["collective_bytes_by_kind"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "broadcast"}
    for k in ("temp_bytes", "alias_bytes"):
        assert rec["memory"][k] is None
    assert rec["hlo_size_chars"] is None and rec["notes"]
    json.dumps(rec)                       # the record is JSON
    if arch.startswith("qwen3-moe"):
        assert not ROUTING_OPS & set(rec["replicated_ops"]), rec
    if shape == "minibatch_lg":           # psw_ring
        assert rec["collective_bytes_by_kind"]["collective-permute"] > 0


def test_the_psw_ring_cell_counts_its_hops(world):
    """EquiformerV2 x minibatch_lg runs psw_ring over the flattened mesh
    of P = 8 devices, one shard of n / P rows each. Its train step issues
    P - 1 hops of the positions' fp32 shard; in each of its L layers, P -
    1 hops of x's bfloat16 shard in the forward and again in the layer's
    recompute (remat), and P hops of the float32 gradient buffer in the
    backward; nothing else is a collective-permute."""
    rec = dryrun.run_cell("equiformer-v2", "minibatch_lg", "single",
                          config="smoke", mesh_shape=(2, 4))
    from repro_torch.configs import get_arch
    cfg = get_arch("equiformer-v2").smoke_config
    P, L, C = 8, cfg.n_layers, cfg.d_hidden
    K = (cfg.l_max + 1) ** 2
    n_loc = rec["meta"]["n_nodes"] // P
    shard = n_loc * K * C
    hops = (P - 1) + L * (2 * (P - 1) + P)
    assert rec["collective_op_counts"]["collective-permute"] == hops
    assert rec["collective_bytes_by_kind"]["collective-permute"] == (
        (P - 1) * n_loc * 3 * 4 + L * (2 * (P - 1) * shard * 2
                                       + P * shard * 4))


def test_skipped_cell_says_why():
    rec = dryrun.run_cell("granite-3-2b", "long_500k", "single")
    assert rec["status"] == "skipped" and "sub-quadratic" in rec[
        "skip_reason"]


def test_an_unportable_cell_records_the_op(world, tmp_path, capsys,
                                          monkeypatch):
    """A model step that reaches `nonzero`, which has no meta DTensor form
    (here GIN's neighbour sum, patched to pick its live messages with it):
    the record says error and names the op."""
    import torch
    from repro_torch.graph import segment_ops

    def picks_live_rows(msgs, dst, n_nodes, sorted_=False):
        return msgs[torch.nonzero(dst).flatten()]

    monkeypatch.setattr(segment_ops, "scatter_sum", picks_live_rows)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "gin-tu", "--shape", "full_graph_sm",
                     "--mesh", "single", "--out", str(tmp_path)])
    with open(tmp_path / "gin-tu__full_graph_sm__single.json") as f:
        rec = json.load(f)
    assert rec["status"] == "error" and "nonzero" in rec["error"]


def test_cli_writes_a_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gin-tu", "--shape", "full_graph_sm", "--mesh", "single", "--out",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(tmp_path / "gin-tu__full_graph_sm__single.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["meta"] == {"n_nodes": 2708, "n_edges": 10556,
                           "edges_per_step": 10556}
