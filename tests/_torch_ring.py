"""Run a function on a ring of spawned CPU processes (`torch.distributed`
over gloo, rendezvous through a file store), for the port's PSW ring tests.

The children import only torch, numpy and the port. Each runs
`target(rank, world, *args)` inside an initialised process group and sends
back its result (or its traceback); `spawn_ring` returns the results by
rank, or raises if a child failed or the ring did not finish in time."""
import multiprocessing
import os
import queue
import time
import traceback


def _child(target, rank, world, store, results, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            results.put((rank, True, target(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn_ring(target, world, tmp_path, *args, timeout=120.0):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(str(tmp_path), f"ring_store_{time.time_ns()}")
    procs = [ctx.Process(target=_child,
                         args=(target, r, world, store, results, args))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < world:
            try:
                rank, ok, res = results.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"the ring of {world} did not finish in "
                                   f"{timeout} s") from None
            if ok:
                out[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
                break          # the others may wait on it forever
    finally:
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic())
                   if not errors else 1.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise AssertionError("\n".join(errors))
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# ring targets: each rank builds the global arrays from the seed and works
# on its shard (rows rank * n_loc ..., edges rank * e_loc ...)
# ---------------------------------------------------------------------------
def ring_inputs(n, e, f, seed, world):
    """(x, idx, v, idx_aligned): the global arrays of the ring-op checks;
    idx_aligned holds e // world ids in each rank's own rows, in rank
    order."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    idx = rng.integers(0, n, e)
    v = rng.standard_normal((e, f)).astype(np.float32)
    n_loc, e_loc = n // world, e // world
    aligned = (rng.integers(0, n_loc, (world, e_loc))
               + (np.arange(world) * n_loc)[:, None]).reshape(-1)
    return x, idx, v, aligned


def ring_ops(rank, world, n, e, f, seed):
    """The ring and local ops on this rank's shard, with the gradients of
    sum(ring_gather(x)^2) and sum(ring_scatter_sum(v)^2)."""
    import torch
    from repro_torch.graph import psw_ops as po
    x, idx, v, aligned = ring_inputs(n, e, f, seed, world)
    n_loc, e_loc = n // world, e // world
    rows = slice(rank * n_loc, (rank + 1) * n_loc)
    edges = slice(rank * e_loc, (rank + 1) * e_loc)
    ring = po.ring_mesh(n_loc)
    assert (ring.rank, ring.size, ring.n) == (rank, world, n)
    xl = torch.from_numpy(x[rows]).requires_grad_()
    il = torch.from_numpy(idx[edges])
    gathered = po.ring_gather(xl, il, ring)
    (gathered ** 2).sum().backward()
    vl = torch.from_numpy(v[edges]).requires_grad_()
    scattered = po.ring_scatter_sum(vl, il, n, ring)
    (scattered ** 2).sum().backward()
    xb = torch.from_numpy(x[rows]).to(torch.bfloat16).requires_grad_()
    gb = po.ring_gather(xb, il, ring)
    gb.float().sum().backward()
    al = torch.from_numpy(aligned[edges])
    vs = torch.from_numpy(v[edges, 0])
    return {"gather": gathered.detach().numpy(), "gx": xl.grad.numpy(),
            "scatter": scattered.detach().numpy(), "gv": vl.grad.numpy(),
            "gather_bf16": gb.detach().float().numpy(),
            "gx_bf16_dtype": str(xb.grad.dtype),
            "gx_bf16": xb.grad.float().numpy(),
            "local_gather": po.local_gather(torch.from_numpy(x[rows]), al,
                                            ring).numpy(),
            "local_scatter": po.local_scatter_sum(
                torch.from_numpy(v[edges]), al, n, ring).numpy(),
            "local_softmax": po.local_edge_softmax(vs, al, n, ring).numpy()}


def equiformer_shard(rank, world, arrays, cfg_kw, batch):
    """This rank's rows of the psw_ring forward of a PAL-ordered batch
    (its edges the rank's e // world, every dst in its rows)."""
    import torch
    from repro_torch import convert
    from repro_torch.models.gnn import equiformer_v2 as eq
    cfg = eq.EquiformerV2Config(**cfg_kw)
    params = convert.gnn_params_from_arrays(arrays, cfg, "cpu")
    n_loc = batch["species"].shape[0] // world
    e_loc = batch["src"].shape[0] // world
    mine = {}
    for k, a in batch.items():
        per = n_loc if k in ("species", "pos", "node_mask") else e_loc
        mine[k] = torch.from_numpy(a[rank * per:(rank + 1) * per])
    with torch.no_grad():
        return eq.forward(params, mine, cfg).numpy()


def psw_message(s):
    """The width-changing message of the ranked PSW sweep checks."""
    return s[..., :1] * s[..., 1:] + 0.5


def psw_sweep_shard(rank, world, graphs, n_iters):
    """For each (arrays, x) of `graphs`: this rank's intervals of the
    DeviceGraph (`convert.device_graph_from_arrays` of the global arrays,
    then `shard`), the sweep of x's rows under `psw_message` and PageRank,
    both modes, over the world process group."""
    import torch
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.core import psw
    res = []
    for arrays, x in graphs:
        dg = convert.device_graph_from_arrays(arrays, "cpu").shard(rank,
                                                                   world)
        pl = dg.src.shape[0]
        xl = torch.from_numpy(x[rank * pl:(rank + 1) * pl])
        out = {}
        for mode in ("dense_gather", "psw_windows"):
            out["sweep_" + mode] = psw.edge_centric_sweep(
                dg, xl, psw_message, mode, group=dist.group.WORLD).numpy()
            out["pr_" + mode] = psw.pagerank_device(
                dg, n_iters=n_iters, mode=mode,
                group=dist.group.WORLD).numpy()
        res.append(out)
    return res


def compressed_psum_shard(rank, world, grads, residuals):
    """`compressed_psum_tree` of this rank's gradient and residual trees
    (numpy dicts) over the world process group."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim import compressed_psum_tree
    g = {k: torch.from_numpy(v) for k, v in grads[rank].items()}
    r = {k: torch.from_numpy(v) for k, v in residuals[rank].items()}
    mean, new_r = compressed_psum_tree(g, r, dist.group.WORLD)
    return ({k: v.numpy() for k, v in mean.items()},
            {k: v.numpy() for k, v in new_r.items()})


def moe_groups_shard(rank, world, arch, cf, arrays, x):
    """This rank's rows of `moe_mlp` on a (data = world, model = 1) mesh:
    x (B, S, d) Shard(0) over `data`, the layer's params replicated, under
    the default rules; with the balance loss and the collectives counted
    by kind (`dryrun.CollectiveCounter`)."""
    import dataclasses
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import configs
    from repro_torch.launch.dryrun import CollectiveCounter
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import DEFAULT_RULES, ShardingRules, use_rules
    cfg = configs.get_arch(arch).smoke_config
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    mesh = init_device_mesh("cpu", (world, 1),
                            mesh_dim_names=("data", "model"))
    rep = (Replicate(), Replicate())
    lp = {k: DTensor.from_local(torch.from_numpy(v), mesh, rep)
          for k, v in arrays.items()}
    rows = x.shape[0] // world
    xd = DTensor.from_local(
        torch.from_numpy(x[rank * rows:(rank + 1) * rows]), mesh,
        (Shard(0), Replicate()))
    with use_rules(ShardingRules(dict(DEFAULT_RULES), mesh)), \
            CollectiveCounter() as counter:
        out, aux = tf.moe_mlp(lp, xd, cfg)
    return {"rows": out.to_local().numpy(),
            "placements": str(out.placements),
            "aux": float(aux.full_tensor()),
            "counts": dict(counter.counts)}


def reference_subprocess(code, *argv, devices=4, timeout=300):
    """Run `code` (a script that imports the reference) in a fresh
    interpreter on `devices` host devices (jax fixes its device count at
    its first init, so this cannot happen in the test process)."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run([sys.executable, "-c", code, *map(str, argv)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(res.stderr[-4000:])
