"""Graph Isomorphism Network (Xu et al., arXiv:1810.00826), TU-dataset config:
n_layers=5, d_hidden=64, sum aggregator, learnable eps; graph-level readout
sums per-layer node embeddings (jumping knowledge) as in the paper. Port of
the reference `repro/models/gnn/gin.py`.

The neighbour sum is A·x over the live edges, multi-edges counted. It runs
on the psw_spmm kernel: one `prepare_rows` layout of the live edges a
forward, on x's device, then `psw_spmm_rows` in every layer, which launches
the hand-written kernel for CUDA tensors (or raises; it never drops to the
plain version) and takes its plain version, `ref.py::psw_spmm_rows_torch`,
for CPU tensors. Under autograd its backward runs the same kernel over
the layout's transpose (one a forward, shared by the layers). `edge_chunks` is kept so the config equals the
reference's and has no effect: the reference chunks the sum to bound its
per-edge x[src] transient, which the row-gather kernel never builds. The
reference masks each gathered row
(`x[src] * emask`); the kernel skips what is not an edge, so a non-finite
x row reaches only the rows with a live edge from it, where the
reference's 0 · inf also puts NaN in a masked edge's destination (ROADMAP
queue 3, caveat e). For finite x the sums are the reference's, in another
order. The reference's `constrain`s sit where it has them
(`repro_torch.sharding`)."""
from __future__ import annotations

import dataclasses

import torch

from ...kernels.psw_spmm.ops import prepare_rows, psw_spmm_rows
from ...sharding import constrain
from .common import init_mlp, layer_norm, mlp_apply, param_device

__all__ = ["GINConfig", "forward", "init_params", "neighbour_summer"]


@dataclasses.dataclass(frozen=True)
class GINConfig:
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 16
    n_classes: int = 8
    readout: str = "graph"       # node | graph
    edge_chunks: int = 1         # the reference's; no effect (see above)


def init_params(gen, cfg: GINConfig, device=None):
    gen, dev = param_device(gen, device)
    d = cfg.d_hidden
    return {
        "encoder": init_mlp(gen, [cfg.d_in, d], dev),
        "layers": [{"mlp": init_mlp(gen, [d, d, d], dev),
                    "eps": torch.zeros((), device=dev)}     # learnable ε
                   for _ in range(cfg.n_layers)],
        # per-layer readout heads (paper's sum-of-layers readout)
        "heads": [init_mlp(gen, [d, cfg.n_classes], dev)
                  for _ in range(cfg.n_layers + 1)],
    }


def neighbour_summer(batch, n: int, device):
    """x -> each node's sum of x over its live in-edges: psw_spmm over one
    row layout of the batch's live edges, built once for every layer."""
    live = batch["edge_mask"].bool()
    layout = prepare_rows(batch["src"][live], batch["dst"][live], n,
                          device=device)
    return lambda x: psw_spmm_rows(layout, x)


def forward(params, batch, cfg: GINConfig):
    x = mlp_apply(params["encoder"], batch["x"], final_act=True)
    x = constrain(x, "nodes", None)
    nmask = batch["node_mask"].to(x.dtype)[:, None]
    neighbour_sum = neighbour_summer(batch, x.shape[0], x.device)

    layer_reps = [x]
    for lp in params["layers"]:
        h = (1.0 + lp["eps"]) * x + neighbour_sum(x)
        x = mlp_apply(lp["mlp"], h, final_act=True)
        x = constrain(layer_norm(x) * nmask, "nodes", None)
        layer_reps.append(x)

    out = 0.0
    for rep, head in zip(layer_reps, params["heads"]):
        if cfg.readout == "graph":
            rep = (rep * nmask).sum(0, keepdim=True)
        out = out + mlp_apply(head, rep)
    return out
