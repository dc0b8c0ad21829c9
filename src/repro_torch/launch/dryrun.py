"""Multi-pod dry-run (port of the reference `repro/launch/dryrun.py`): run
every (arch × shape) cell once on the production mesh and record roofline
inputs, without a device.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k \\
      --mesh single --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --all --mesh both --workers 3

A cell runs in one process on a `fake` process group of 256 (single pod:
16 x 16, ("data", "model")) or 512 ranks (multi pod: 2 x 16 x 16, ("pod",
"data", "model")) over `make_production_mesh`. Params and inputs are meta
DTensors placed by the sharding rules (`launch/steps.py::build_cell`), and
the step runs once, eagerly, as this process's rank 0. A dispatch mode
below the DTensor layer sees the per-device work: the local shards' ops,
whose FLOPs (`torch.utils.flop_counter`'s formulas) are per device, and
the functional collectives DTensor issues, whose output bytes are keyed
by the reference's kind names (`all-gather`, `all-reduce`,
`reduce-scatter`, `all-to-all`, `collective-permute`), as the reference
counts each collective's result shape in its HLO.

What differs from the reference's record, and why:
- `lower_s` is the plan's build (meta params placed by the rules),
  `compile_s` the eager meta run of the step; there is no compiler.
- `temp_bytes`, `alias_bytes`, `bytes_accessed_per_device`,
  `hlo_size_chars` and `n_while_loops` are null: an eager meta run has no
  buffer assignment, no cost analysis and no HLO. `notes` says so.
- Loops are unrolled in Python, so each microbatch's and layer's
  collectives are counted as they run; nothing is multiplied.
- A CPU process group has no all-to-all: DTensor's shard-to-shard moves
  fall back to an all-gather and a chunk, and are counted as issued.
- An op DTensor has no sharding rule for runs replicated: its inputs are
  all-gathered (those collectives are counted) and the op is named in
  `replicated_ops`.
- Kernels reached through ctypes cannot run on meta tensors, and a few
  plain forms need the data or split a sharded dim. While a cell runs,
  `dry_paths` swaps them in the model modules for forms a meta DTensor
  can run (the only place a kernel's plain version runs off the CPU):
  flash_attention's forward and its recomputing backward, and decode
  attention, for `attention_expanded`; GIN's
  psw_spmm neighbour sum and EquiformerV2's take-mode message scatter
  (whose layouts pick the live edges with `nonzero`) for the reference's
  masked scatter, the LM loss's label gather for a masked sum, and the
  zero KV cache for one placed by the rules. The models keep one path.
- EquiformerV2's psw_ring mode runs on each device's local shard (its
  batch is one rank's rows and edges), and the PSW ring's P2P hop, which
  has no meta backend, becomes `repro_dryrun::collective_permute`: a
  shape-only op counted as a collective-permute of the shard's bytes,
  one a hop, as the ring issues its sends on the card. The ring skips the
  reference's last forward hop (the shard would go nowhere), so a
  gather issues P - 1 hops forward and P backward where the reference's
  loop issues P and P.

`parse_collective_bytes` reads XLA HLO, which the port never produces; it
stays in the reference.
"""
import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

__all__ = ["run_cell", "orchestrate", "main", "CollectiveCounter",
           "attention_expanded", "dry_paths"]

_MISSING_RULE = re.compile(
    r"Operator (\S+) does not have a sharding strategy registered")

_NOTES = [
    "lower_s: plan build; compile_s: the eager meta run of the step",
    "temp_bytes, alias_bytes, bytes_accessed_per_device, hlo_size_chars, "
    "n_while_loops: null (an eager meta run has no buffer assignment, cost "
    "analysis or HLO)",
    "collective bytes: output bytes of each functional collective DTensor "
    "issued on rank 0; CPU process groups turn all-to-all into all-gather "
    "+ chunk",
    "flops_per_device: torch.utils.flop_counter formulas on the local "
    "shards' ops (below the DTensor layer)",
]


def _collective_kinds():
    import torch
    _permute_op()
    native = torch.ops._c10d_functional
    c10d = torch.ops.c10d
    kinds = {
        native.all_gather_into_tensor: "all-gather",
        native.all_gather_into_tensor_coalesced: "all-gather",
        native.all_reduce: "all-reduce",
        native.all_reduce_coalesced: "all-reduce",
        native.reduce_scatter_tensor: "reduce-scatter",
        native.reduce_scatter_tensor_coalesced: "reduce-scatter",
        native.all_to_all_single: "all-to-all",
        native.broadcast: "broadcast",
        c10d._allgather_base_: "all-gather",
        c10d.allgather_: "all-gather",
        c10d.allreduce_: "all-reduce",
        c10d._reduce_scatter_base_: "reduce-scatter",
        c10d.reduce_scatter_: "reduce-scatter",
        c10d.alltoall_base_: "all-to-all",
        c10d.alltoall_: "all-to-all",
        c10d.send: "collective-permute",
        c10d.recv_: "collective-permute",
        c10d.broadcast_: "broadcast",
        torch.ops.repro_dryrun.collective_permute: "collective-permute",
    }
    return kinds


def _permute_op():
    """`repro_dryrun::collective_permute(t, to, frm)`: send t to rank `to`
    and receive its like from `frm`, as the PSW ring's `_shift` does, for
    meta tensors only (a shape, no data). The counter records each call
    as a collective-permute of t's bytes."""
    import torch
    if not hasattr(torch.ops.repro_dryrun, "collective_permute"):
        @torch.library.custom_op("repro_dryrun::collective_permute",
                                 mutates_args=())
        def permute(t: torch.Tensor, to: int, frm: int) -> torch.Tensor:
            raise NotImplementedError("the dry-run's collective-permute "
                                      "takes meta tensors only")

        @permute.register_fake
        def _(t, to, frm):
            return torch.empty_like(t)
    return torch.ops.repro_dryrun.collective_permute


def _nbytes(tree) -> int:
    import torch
    from torch.utils import _pytree as pytree
    total = 0
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _local_bytes(tree) -> int:
    """Per-device bytes of a tree of (D)Tensors: each DTensor's local
    shard on this rank."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree
    total = 0
    for t in pytree.tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def CollectiveCounter():
    """A dispatch mode that counts below the DTensor layer: ops on DTensors
    are passed on (DTensor turns them into local ops and collectives,
    which come back through this mode); every other op is run and, when it
    is a collective, its kind, count and output bytes are recorded, and
    when it has a FLOP formula, its FLOPs. The fake-tensor ops DTensor runs
    to propagate global shapes are not counted."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry
    kinds = _collective_kinds()

    class _Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes_by_kind = Counter()
            self.counts = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if any(issubclass(t, FakeTensor) for t in types):
                return out      # DTensor's shape propagation, global shapes
            packet = getattr(func, "_overloadpacket", None)
            kind = kinds.get(packet)
            if kind is not None:
                self.counts[kind] += 1
                self.bytes_by_kind[kind] += _nbytes(out)
            elif packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            return out

    return _Counter()


_REPLICATED = set()


def _replicate_op(op_name: str) -> None:
    """Give an op DTensor has no rule for a replicate-everything rule."""
    import torch
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.experimental import register_sharding
    ns, name, overload = (op_name.split(".") + ["default"])[:3]
    op = getattr(getattr(getattr(torch.ops, ns), name), overload)
    n_out = len(op._schema.returns)

    @register_sharding(op)
    def _all_replicated(*args, **kwargs):
        ins = [Replicate() if isinstance(a, DTensorSpec) else None
               for a in args]
        return [([Replicate()] * n_out, ins)]

    _REPLICATED.add(op_name)


def _init_world(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def attention_expanded(q, k, v, causal: bool = True, q_pos0: int = 0):
    """softmax(q k^T / sqrt(D)) v of (B, S|T, H|Hkv, D) tensors in one
    unchunked pass, GQA by expanding k and v to the H query heads (query
    head h reads kv head h // (H / Hkv)); the causal mask aligned top-left,
    query s at position q_pos0 + s. fp32 scores, out in q's dtype. A query
    head dim sharded over a mesh cannot be split into (Hkv, H / Hkv)
    groups, an expanded kv head dim can be sharded like it, and each device
    then attends over its own batch rows and heads (`local_map`, no
    collective), as a partitioner shards attention over batch and heads;
    a cache sharded along T (decode) takes DTensor's own strategies."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]

    def heads(t):
        return t[:, :, :, None].expand(B, T, Hkv, H // Hkv, D).reshape(
            B, T, H, D)

    def attend(q, k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
        if causal:
            qpos = q_pos0 + torch.arange(S, device=q.device)
            mask = torch.arange(T, device=q.device)[None, :] <= qpos[:, None]
            s = torch.where(mask, s, -torch.inf)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)

    kx, vx = heads(k), heads(v)
    if not isinstance(q, DTensor) or Shard(1) in k.placements:
        return attend(q, kx, vx)
    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in q.placements)
    mesh = q.device_mesh
    q, kx, vx = (t.redistribute(mesh, pl) for t in (q, kx, vx))
    return local_map(lambda a, b, c: (attend(a, b, c),),
                     out_placements=(pl,), in_placements=(pl, pl, pl))(
        q, kx, vx)[0]


def _attention_backward(q, k, v, g, causal: bool):
    """(dq, dk, dv) of `attention_expanded` against g, recomputed in fp32:
    the backward of flash_attention's autograd function, which recomputes
    the forward as the kernel's does."""
    import torch
    with torch.enable_grad():
        qc, kc, vc = (t.detach().float().requires_grad_() for t in (q, k, v))
        grads = torch.autograd.grad(attention_expanded(qc, kc, vc, causal),
                                    (qc, kc, vc), g.float())
    return tuple(d.to(t.dtype) for d, t in zip(grads, (q, k, v)))


def _label_logits(logits, labels):
    """The label's logit as a masked sum: exact, and its backward stays
    vocab-sharded where a gather's scatters into a replicated zero
    tensor."""
    import torch
    iota = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(iota == labels.long()[..., None], logits, 0.0).sum(-1)


def _init_cache(cfg, batch: int, max_seq: int, dtype=None, device=None):
    """The zero KV cache as meta DTensors placed by the active rules at
    the cells' cache axes (`steps.CACHE_AXES`)."""
    import torch
    from ..sharding import current_rules
    from .steps import CACHE_AXES, _meta
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {name: _meta(shape, dtype or torch.bfloat16, current_rules(),
                        CACHE_AXES) for name in ("k", "v")}


def _neighbour_summer(batch, n: int, device):
    """GIN's neighbour sum in the reference's form, scatter_sum(x[src] *
    edge_mask, dst): no row layout, which needs the edges' values."""
    from ..graph.segment_ops import scatter_sum
    src, dst = batch["src"], batch["dst"]
    emask = batch["edge_mask"][:, None]
    return lambda x: scatter_sum(x[src] * emask.to(x.dtype), dst, n)


def _message_scatterer(emask, dst, chunks, n: int, device):
    """EquiformerV2's message scatter in the reference's form,
    scatter_sum(msg * edge_mask, dst) a chunk: no row layout, which picks
    the live edges by their values (`nonzero`)."""
    from ..graph.segment_ops import scatter_sum

    def scatter(msg, c):
        sl = chunks[c]
        return scatter_sum(msg * emask[sl].to(msg.dtype)[:, None, None],
                           dst[sl], n)

    return scatter


def _shift(t, to: int, frm: int):
    """The PSW ring's hop (`psw_ops._shift`) on a meta tensor."""
    return _permute_op()(t.contiguous(), to, frm)


def _ring_forward(forward):
    """EquiformerV2's forward with psw_ring mode on each device's shard.
    That mode takes a rank's rows and edges (the model's docstring), so the
    batch's DTensors are cut into their local shards along the ring (dim 0
    split over every mesh dim, the flattened mesh the reference's
    `ring_mesh` makes) and the replicated params taken whole, their
    gradients summed over the devices; the rows come back as the nodes'
    shards. Every other mode, and plain tensors, run as they are."""
    def dry_forward(params, batch, cfg, ring=None):
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        from torch.utils import _pytree as pytree
        pos = batch["pos"]
        if cfg.gather_mode != "psw_ring" or not isinstance(pos, DTensor):
            return forward(params, batch, cfg, ring)
        mesh = pos.device_mesh
        rows = (Shard(0),) * mesh.ndim

        def local(t, pl, grad_pl):
            if not isinstance(t, DTensor):
                return t
            return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

        params = pytree.tree_map(
            lambda t: local(t, (Replicate(),) * mesh.ndim,
                            (Partial(),) * mesh.ndim), params)
        batch = {k: local(v, rows, rows) for k, v in batch.items()}
        return DTensor.from_local(forward(params, batch, cfg, ring), mesh,
                                  rows, run_check=False)

    return dry_forward


@contextlib.contextmanager
def dry_paths():
    """Swap the model modules' kernel calls and data-bound steps for the
    dry-run's meta-DTensor forms (module docstring) while the block runs."""
    from ..graph import psw_ops
    from ..kernels.flash_attention import ops as fa_ops
    from ..models import transformer
    from ..models.gnn import equiformer_v2, gin
    swaps = [
        (fa_ops, "_forward", attention_expanded),
        (fa_ops, "_backward", _attention_backward),
        (transformer, "cached_attention",
         lambda q, ck, cv, pos: attention_expanded(q, ck, cv, True, pos)),
        (transformer, "label_logits", _label_logits),
        (transformer, "init_cache", _init_cache),
        (gin, "neighbour_summer", _neighbour_summer),
        (equiformer_v2, "message_scatterer", _message_scatterer),
        (equiformer_v2, "forward", _ring_forward(equiformer_v2.forward)),
        (psw_ops, "_shift", _shift),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _run_step(plan):
    from torch.distributed.tensor.experimental import implicit_replication
    from ..sharding import use_rules
    counter = CollectiveCounter()
    with use_rules(plan.rules), implicit_replication(), dry_paths(), \
            counter:
        out = plan.fn(*plan.args)
    return out, counter


_MAX_REPLICATED = 8     # ops given the replicate rule in one cell, at most


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str = None,
             config: str = "full", mesh_shape=None) -> dict:
    """One cell's record. `config`: "full" (the published config) or
    "smoke" (the arch's reduced config); `mesh_shape`: None for the
    production mesh, or a smaller shape with the same axis names (a fake
    world of its size, for tests)."""
    import dataclasses

    from ..configs import get_arch
    from ..sharding import DEFAULT_RULES, ShardingRules
    from .mesh import make_production_mesh
    from .steps import build_cell

    spec = get_arch(arch)
    if config == "smoke":
        spec = dataclasses.replace(spec, config=spec.smoke_config)
    cell = spec.shapes[shape]
    result = {"arch": arch, "shape": shape, "mesh": mesh_kind,
              "kind": cell.kind, "dims": cell.dims}
    if cell.skip:
        result["status"] = "skipped"
        result["skip_reason"] = cell.skip
        return result

    multi = mesh_kind == "multi"
    if mesh_shape is None:
        world = 512 if multi else 256
        _init_world(world)
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    else:
        from torch.distributed.device_mesh import init_device_mesh
        world = math.prod(mesh_shape)
        _init_world(world)
        mesh = init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=(
            ("pod", "data", "model") if multi else ("data", "model")))
    rules = ShardingRules(rules=dict(DEFAULT_RULES), mesh=mesh)
    for attempt in range(_MAX_REPLICATED + 1):
        t0 = time.time()
        plan = build_cell(spec, shape, rules, world)
        t_lower = time.time()
        try:
            out, counter = _run_step(plan)
            break
        except NotImplementedError as e:
            m = _MISSING_RULE.search(str(e))
            if m is None or attempt == _MAX_REPLICATED:
                raise
            _replicate_op(m.group(1))
    t_compile = time.time()

    by_kind = dict(counter.bytes_by_kind)
    result.update({
        "status": "ok",
        "n_devices": int(world),
        "lower_s": round(t_lower - t0, 1),
        "compile_s": round(t_compile - t_lower, 1),
        "meta": plan.meta,
        "config": config,
        "flops_per_device": float(counter.flops),
        "bytes_accessed_per_device": None,
        "memory": {
            "argument_bytes": int(_local_bytes(plan.args)),
            "output_bytes": int(_local_bytes(out)),
            "temp_bytes": None,
            "alias_bytes": None,
        },
        "collective_bytes_per_device": int(sum(by_kind.values())),
        "collective_bytes_by_kind": by_kind,
        "collective_op_counts": dict(counter.counts),
        "n_while_loops": None,
        "hlo_size_chars": None,
        "replicated_ops": sorted(_REPLICATED),
        "notes": list(_NOTES),
    })
    return result


ALL_SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k",
                   "full_graph_sm", "minibatch_lg", "ogb_products", "molecule",
                   "train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]


def orchestrate(mesh_kinds, out_dir: str, workers: int, only_missing: bool,
                timeout: int):
    """Run each cell in its own subprocess (isolation: one bad cell can't
    take down the sweep; parallelism across CPU cores)."""
    from ..configs import ARCH_IDS, get_arch
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for arch in ARCH_IDS:
        spec = get_arch(arch)
        for shape in spec.shapes:
            for mk in mesh_kinds:
                fname = f"{arch}__{shape}__{mk}.json".replace("/", "_")
                fpath = os.path.join(out_dir, fname)
                if only_missing and os.path.exists(fpath):
                    with open(fpath) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            continue
                jobs.append((arch, shape, mk, fpath))

    def run_one(job):
        arch, shape, mk, fpath = job
        if os.path.exists(fpath):
            os.remove(fpath)            # the child writes the new record
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mk, "--out", out_dir]
        t0 = time.time()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout,
                                  env={**os.environ,
                                       "PYTHONPATH": os.environ.get(
                                           "PYTHONPATH", "src")})
            ok = proc.returncode == 0
            if not ok and not os.path.exists(fpath):
                with open(fpath, "w") as f:
                    json.dump({"arch": arch, "shape": shape, "mesh": mk,
                               "status": "error",
                               "stderr": proc.stderr[-4000:]}, f, indent=1)
        except subprocess.TimeoutExpired:
            with open(fpath, "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mk,
                           "status": "timeout", "timeout_s": timeout}, f,
                          indent=1)
            ok = False
        print(f"[{'OK' if ok else 'FAIL'}] {arch} × {shape} × {mk} "
              f"({time.time() - t0:.0f}s)", flush=True)
        return ok

    with ThreadPoolExecutor(max_workers=workers) as ex:
        results = list(ex.map(run_one, jobs))
    print(f"done: {sum(results)}/{len(results)} ok")


def _error_of(exc: BaseException) -> str:
    """The exception's message, first line: it names the op DTensor or a
    meta tensor refused."""
    msg = str(exc).strip().splitlines()
    return f"{type(exc).__name__}: {msg[0] if msg else ''}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        orchestrate(mesh_kinds, args.out, args.workers,
                    only_missing=not args.force, timeout=args.timeout)
        return

    os.makedirs(args.out, exist_ok=True)
    failed = False
    for mk in mesh_kinds:
        fname = f"{args.arch}__{args.shape}__{mk}.json".replace("/", "_")
        fpath = os.path.join(args.out, fname)
        try:
            result = run_cell(args.arch, args.shape, mk, args.out)
        except Exception as exc:
            result = {"arch": args.arch, "shape": args.shape, "mesh": mk,
                      "status": "error", "error": _error_of(exc),
                      "traceback": traceback.format_exc()}
        with open(fpath, "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps({k: v for k, v in result.items()
                          if k not in ("traceback",)}, indent=1))
        if result["status"] == "error":
            print(result["traceback"], file=sys.stderr)
            failed = True
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
