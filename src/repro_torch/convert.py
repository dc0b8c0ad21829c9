"""State carried across from the reference package: the port's stand-in for
weights. A store or plan travels as a flat dict of numpy arrays, so the
reference's objects convert without this module importing `repro`:
`pal_to_arrays` / `plan_to_arrays` read any object with the reference's
attribute names, and `pal_from_arrays` / `plan_from_arrays` rebuild the
port's own `GraphPAL` / device-resident `FrontierPlan`.

Keys: `intervals.{n_partitions,interval_len}`;
`partitions.{i}.{interval,src,dst,etype,src_vertices,src_ptr,dst_perm,
dst_vertices,dst_ptr}` plus optional `partitions.{i}.dead` and
`partitions.{i}.columns.{name}`; `vertex_columns.{name}.{i}`. A plan's keys
are the reference's field names, those of its virtual-row ELL (`idx`,
`mask`, `row_dst`, `k_slots`, ...); `plan_from_arrays` compacts the ELL's
live slots row by row into the port's destination CSR (`col`, `edge_ptr`)
and cuts the heavy destinations into chunks on the target device.

A PSW `DeviceGraph` travels the same way (`device_graph_to_arrays` /
`device_graph_from_arrays`): the reference's field names as keys, its jnp
arrays as numpy; the port's destination CSR `seg_ptr` is derived from
`dst_local` and `mask`.

A transformer's params (`transformer_params_to_arrays` /
`transformer_params_from_arrays`) travel as dotted keys of the reference's
pytree: `embed`, `layers.attn.wq`, ..., `layers.mlp.w_down`, `layers.ln1`,
`final_norm`, `lm_head`, each layer leaf with its leading `n_layers` axis.
A KV cache travels the same way (`k`, `v`; `kv_cache_from_arrays`).
A GNN's params (`gnn_params_to_arrays` / `gnn_params_from_arrays`: GIN,
PNA, MeshGraphNet, EquiformerV2) are nested lists and dicts; a list item's
key is its index: `encoder.0.w`, `layers.3.mlp.1.b`, `layers.3.eps`,
`heads.5.0.w`, `layers.11.so2.m2_i`. A bert4rec's params
(`bert4rec_params_to_arrays` / `bert4rec_params_from_arrays`) likewise:
`item_embed`, `blocks.1.wq`, `out_bias`, ...
An AdamW state over any of these trees (`adamw_state_to_arrays` /
`adamw_state_from_arrays`) travels as `m.<param key>`, `v.<param key>`
and `step`.
bfloat16 leaves cross as float32, which holds them exactly."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

import torch
from torch.utils import _pytree as pytree

from .core.pal import EdgePartition, GraphPAL, IntervalMap
from .core.psw import DeviceGraph, segment_ptr
from .kernels.frontier_expand.ops import FrontierPlan, hub_chunks
from .models import bert4rec
from .models.gnn import equiformer_v2, gin, meshgraphnet, pna
from .models.transformer import TransformerConfig, _layer_shapes

__all__ = ["adamw_state_from_arrays", "adamw_state_to_arrays",
           "bert4rec_params_from_arrays", "bert4rec_params_to_arrays",
           "device_graph_from_arrays", "device_graph_to_arrays",
           "gnn_params_from_arrays", "gnn_params_to_arrays",
           "kv_cache_from_arrays", "kv_cache_to_arrays", "pal_from_arrays",
           "pal_to_arrays", "plan_from_arrays", "plan_to_arrays",
           "transformer_params_from_arrays", "transformer_params_to_arrays"]

_PART_ARRAYS = ("src", "dst", "etype", "src_vertices", "src_ptr", "dst_perm",
                "dst_vertices", "dst_ptr")
_PLAN_ARRAYS = ("idx", "mask", "row_dst")
_PLAN_INTS = ("n_src", "n_dst", "n_edges", "k_slots")
_DG_INTS = ("n_partitions", "interval_len", "n_edges")
_DG_ARRAYS = (("src", np.int32), ("dst_local", np.int32), ("mask", bool),
              ("outdeg", np.int32))
_DG_WINDOW = ("send_idx", "edge_owner", "edge_slot")


def pal_to_arrays(g) -> Dict[str, np.ndarray]:
    """Flatten a GraphPAL (either package's) into a dict of numpy arrays."""
    d = {"intervals.n_partitions": np.asarray(g.intervals.n_partitions),
         "intervals.interval_len": np.asarray(g.intervals.interval_len)}
    for i, p in enumerate(g.partitions):
        pre = f"partitions.{i}."
        d[pre + "interval"] = np.asarray(p.interval, np.int64)
        for name in _PART_ARRAYS:
            d[pre + name] = np.asarray(getattr(p, name))
        if p.dead is not None:
            d[pre + "dead"] = np.asarray(p.dead)
        for name, col in p.columns.items():
            d[pre + "columns." + name] = np.asarray(col)
    for name, per_interval in g.vertex_columns.items():
        for i, col in enumerate(per_interval):
            d[f"vertex_columns.{name}.{i}"] = np.asarray(col)
    return d


def pal_from_arrays(d: Dict[str, np.ndarray]) -> GraphPAL:
    """Rebuild a port GraphPAL from `pal_to_arrays` output (arrays copied,
    so the source store and the port never share a mutable array)."""
    iv = IntervalMap(int(d["intervals.n_partitions"]),
                     int(d["intervals.interval_len"]))
    parts = []
    for i in range(iv.n_partitions):
        pre = f"partitions.{i}."
        cols = {k[len(pre) + len("columns."):]: np.array(v)
                for k, v in d.items() if k.startswith(pre + "columns.")}
        lo, hi = (int(v) for v in d[pre + "interval"])
        dead = d.get(pre + "dead")
        parts.append(EdgePartition(
            (lo, hi), *(np.array(d[pre + name]) for name in _PART_ARRAYS),
            columns=cols, dead=None if dead is None else np.array(dead)))
    vcols: Dict[str, list] = {}
    for k in sorted((k for k in d if k.startswith("vertex_columns.")),
                    key=lambda k: int(k.rsplit(".", 1)[1])):
        name = k[len("vertex_columns."):].rsplit(".", 1)[0]
        vcols.setdefault(name, []).append(np.array(d[k]))
    return GraphPAL(iv, parts, vcols)


def plan_to_arrays(plan) -> Dict[str, np.ndarray]:
    """Flatten a reference FrontierPlan into a dict."""
    return {name: np.asarray(getattr(plan, name))
            for name in _PLAN_INTS + _PLAN_ARRAYS}


def plan_from_arrays(d: Dict[str, np.ndarray], device) -> FrontierPlan:
    """Rebuild a port FrontierPlan on `device` from `plan_to_arrays` output."""
    n_src, n_dst = int(d["n_src"]), int(d["n_dst"])
    idx = np.asarray(d["idx"], np.int32)
    mask = np.asarray(d["mask"], bool)
    row_dst = np.asarray(d["row_dst"], np.int32)
    # the kernel gathers x[col] unchecked and walks edges by destination
    live = idx[mask]
    if (idx.shape != mask.shape or idx.shape[0] != row_dst.shape[0]
            or (live.size and (live.min() < 0 or live.max() >= n_src))
            or (row_dst.size and (row_dst.min() < 0
                                  or row_dst.max() > n_dst))
            or (np.diff(row_dst) < 0).any()):
        raise ValueError("plan arrays are inconsistent: idx/mask/row_dst "
                         "shapes, source ids or destination order")
    row_end = np.zeros(idx.shape[0] + 1, np.int64)
    np.cumsum(mask.sum(1), out=row_end[1:])
    edge_ptr = torch.from_numpy(
        row_end[np.searchsorted(row_dst, np.arange(n_dst + 1))]).to(device)
    return FrontierPlan(torch.from_numpy(live).to(device), edge_ptr,
                        n_src=n_src, n_dst=n_dst, n_edges=int(d["n_edges"]),
                        **hub_chunks(edge_ptr))


def device_graph_to_arrays(dg) -> Dict[str, np.ndarray]:
    """Flatten a DeviceGraph (either package's) into a dict of numpy
    arrays; the window plan's keys are absent when it was not built."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    d = {name: np.asarray(getattr(dg, name)) for name in _DG_INTS}
    for name, _ in _DG_ARRAYS:
        d[name] = host(getattr(dg, name))
    for name in _DG_WINDOW:
        if getattr(dg, name) is not None:
            d[name] = host(getattr(dg, name))
    return d


def device_graph_from_arrays(d: Dict[str, np.ndarray], device) -> DeviceGraph:
    """Rebuild a port DeviceGraph on `device` from `device_graph_to_arrays`
    output. The sweep gathers by these ids unchecked and sums each
    partition's destinations as contiguous runs, so ids out of range, a
    mask that is not a prefix, or destinations out of order raise."""
    P, L = int(d["n_partitions"]), int(d["interval_len"])
    a = {name: np.array(d[name], dt) for name, dt in _DG_ARRAYS}
    S, D, M = a["src"], a["dst_local"], a["mask"]
    n_valid = M.sum(1)
    prefix = M == (np.arange(M.shape[1]) < n_valid[:, None])
    dsorted = np.where(M, D, L)
    if (S.shape != D.shape or S.shape != M.shape or S.shape[0] != P
            or a["outdeg"].shape != (P, L) or not prefix.all()
            or (S[M].size and (S[M].min() < 0 or S[M].max() >= P * L))
            or (D[M].size and (D[M].min() < 0 or D[M].max() >= L))
            or (np.diff(dsorted, axis=1) < 0).any()
            or int(n_valid.sum()) != int(d["n_edges"])):
        raise ValueError("DeviceGraph arrays are inconsistent: shapes, ids, "
                         "padding or destination order")
    dev = torch.device(device)
    t = {name: torch.from_numpy(v).to(dev) for name, v in a.items()}
    window = {}
    if all(name in d for name in _DG_WINDOW):
        send_idx = np.array(d["send_idx"], np.int32)
        owner = np.array(d["edge_owner"], np.int32)
        slot = np.array(d["edge_slot"], np.int32)
        W = send_idx.shape[-1]
        if (send_idx.shape[:2] != (P, P) or owner.shape != S.shape
                or slot.shape != S.shape
                or (send_idx.size and (send_idx.min() < 0
                                       or send_idx.max() >= L))
                or (owner.size and (owner.min() < 0 or owner.max() >= P))
                or (slot.size and (slot.min() < 0 or slot.max() >= W))):
            raise ValueError("DeviceGraph window plan is inconsistent")
        window = {name: torch.from_numpy(v).to(dev)
                  for name, v in (("send_idx", send_idx),
                                  ("edge_owner", owner), ("edge_slot", slot))}
    return DeviceGraph(n_partitions=P, interval_len=L,
                       n_edges=int(d["n_edges"]),
                       seg_ptr=segment_ptr(t["dst_local"], t["mask"], L),
                       **t, **window)


def _host_array(a) -> np.ndarray:
    """A leaf as numpy: a torch tensor, a jax or numpy array. bfloat16
    (torch's, or the ml_dtypes one jax hands numpy) widens to float32."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _flatten(tree, prefix: str = ""):
    """(dotted key, leaf) pairs of nested dicts and lists (a list item's
    key is its index; a tuple is a leaf: a shape)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for name, v in items:
        if isinstance(v, (dict, list)):
            yield from _flatten(v, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", v


def transformer_params_to_arrays(tree) -> Dict[str, np.ndarray]:
    """Flatten a transformer params tree (either package's nested dicts)
    into dotted keys of numpy arrays."""
    return {k: _host_array(v) for k, v in _flatten(tree)}


def _param_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    V, d = cfg.padded_vocab, cfg.d_model
    shapes = {"embed": (V, d), "final_norm": (d,), "lm_head": (V, d)}
    shapes.update((k, (cfg.n_layers, *shp))
                  for k, shp in _flatten(_layer_shapes(cfg), "layers."))
    return shapes


def _tree_from_arrays(d, shapes, dtype, device):
    if set(d) != set(shapes):
        raise ValueError(f"keys differ from the config's: missing "
                         f"{sorted(set(shapes) - set(d))}, extra "
                         f"{sorted(set(d) - set(shapes))}")
    dev = torch.device(device)
    tree: Dict = {}
    for key, shp in shapes.items():
        a = _host_array(d[key])
        if a.shape != shp:
            raise ValueError(f"{key} has shape {a.shape}, expected {shp}")
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = torch.from_numpy(np.array(a)).to(
            device=dev, dtype=dtype)
    return tree


def transformer_params_from_arrays(d: Dict[str, np.ndarray],
                                   cfg: TransformerConfig, device):
    """Rebuild a port params tree in `cfg.param_dtype` on `device` from
    `transformer_params_to_arrays` output; keys and shapes must be the
    config's (a MoE config's `layers.mlp` holds `router`, `w_gate`, `w_up`
    and `w_down` with their expert axis)."""
    return _tree_from_arrays(d, _param_shapes(cfg), cfg.param_dtype, device)


kv_cache_to_arrays = transformer_params_to_arrays


def kv_cache_from_arrays(d: Dict[str, np.ndarray], cfg: TransformerConfig,
                         device, dtype=torch.bfloat16):
    """Rebuild a KV cache ({"k", "v"}: (n_layers, B, T, n_kv_heads,
    head_dim)) in `dtype` on `device`."""
    k = np.shape(d.get("k", ()))
    if len(k) != 5:
        raise ValueError(f"cache k has shape {k}, expected 5 dimensions")
    shp = (cfg.n_layers, k[1], k[2], cfg.n_kv_heads, cfg.head_dim)
    return _tree_from_arrays(d, {"k": shp, "v": shp}, dtype, device)


_GNN_MODELS = {gin.GINConfig: gin, pna.PNAConfig: pna,
               meshgraphnet.MeshGraphNetConfig: meshgraphnet,
               equiformer_v2.EquiformerV2Config: equiformer_v2}


def gnn_params_to_arrays(tree) -> Dict[str, np.ndarray]:
    """Flatten a GNN params tree (either package's nested lists and dicts)
    into dotted keys of numpy arrays."""
    return {k: _host_array(v) for k, v in _flatten(tree)}


def gnn_params_from_arrays(d: Dict[str, np.ndarray], template_or_cfg,
                           device):
    """Rebuild a port GNN params tree on `device` from
    `gnn_params_to_arrays` output. The tree's layout, shapes and dtypes are
    a port params tree's (`template_or_cfg`) or those `init_params` gives
    a GIN, PNA, MeshGraphNet or EquiformerV2 config; keys and shapes must
    match them."""
    template = template_or_cfg
    if dataclasses.is_dataclass(template_or_cfg):
        model = _GNN_MODELS.get(type(template_or_cfg))
        if model is None:
            raise TypeError(f"no GNN model for "
                            f"{type(template_or_cfg).__name__}")
        template = model.init_params(torch.Generator(), template_or_cfg,
                                     device="meta")
    return _tree_from_template(d, template, device)


def _tree_from_template(d: Dict[str, np.ndarray], template, device):
    """A params tree of `template`'s layout, shapes and dtypes on `device`,
    its leaves from `d` (dotted keys, a list item's key its index)."""
    leaves = dict(_flatten(template))
    if set(d) != set(leaves):
        raise ValueError(f"keys differ from the template's: missing "
                         f"{sorted(set(leaves) - set(d))}, extra "
                         f"{sorted(set(d) - set(leaves))}")
    dev = torch.device(device)

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}.") for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, f"{prefix}{i}.") for i, v in enumerate(node)]
        key = prefix[:-1]
        a = _host_array(d[key])
        if a.shape != tuple(node.shape):
            raise ValueError(f"{key} has shape {a.shape}, expected "
                             f"{tuple(node.shape)}")
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=node.dtype)

    return build(template, "")


bert4rec_params_to_arrays = gnn_params_to_arrays


def bert4rec_params_from_arrays(d: Dict[str, np.ndarray],
                                cfg: bert4rec.Bert4RecConfig, device):
    """Rebuild a port bert4rec params tree on `device` from
    `bert4rec_params_to_arrays` output; keys and shapes must be those
    `bert4rec.init_params` gives `cfg`."""
    template = bert4rec.init_params(torch.Generator(), cfg, device="meta")
    return _tree_from_template(d, template, device)


# an AdamW state ({"m", "v", "step"}, either package's) flattens as any
# tree does: `m.<param key>`, `v.<param key>` and `step`
adamw_state_to_arrays = gnn_params_to_arrays


def adamw_state_from_arrays(d: Dict[str, np.ndarray], params, device):
    """Rebuild a port AdamW state on `device` from `adamw_state_to_arrays`
    output: m and v float32 trees of the port params tree `params`'s
    layout and shapes (keys must match them), step an int32 0-d tensor."""
    template = pytree.tree_map(
        lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta"),
        params)
    if "step" not in d:
        raise ValueError("the state has no step")
    moments = {}
    for name in ("m", "v"):
        pre = name + "."
        moments[name] = _tree_from_template(
            {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)},
            template, device)
    extra = sorted(k for k in d
                   if k != "step" and not k.startswith(("m.", "v.")))
    if extra:
        raise ValueError(f"keys outside m, v and step: {extra}")
    step = torch.tensor(int(np.asarray(d["step"])), dtype=torch.int32,
                        device=torch.device(device))
    return {**moments, "step": step}
