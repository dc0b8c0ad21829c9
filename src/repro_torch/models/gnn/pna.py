"""Principal Neighbourhood Aggregation (Corso et al., arXiv:2004.05718).

n_layers=4, d_hidden=75, aggregators={mean,max,min,std},
scalers={identity, amplification, attenuation} — 12 aggregate channels per
message dim, combined with a linear 'post' layer per PNA layer.
Message passing is PAL-ordered gather + segment reductions (`index_add_`
and `scatter_reduce_`, as the reference's are XLA scatters, not a Pallas
kernel). Port of the reference `repro/models/gnn/pna.py`.

The degree scalers count a padded edge (edge_mask False) at node n - 1, as
the reference does: where a sampled batch fills every node slot, node
n - 1 is real and its scalers see those edges (ROADMAP queue 3, caveat l).
"""
from __future__ import annotations

import dataclasses

import torch

from ...graph.chunked import fold_aggregate, multi_aggregate_chunked
from ...graph.segment_ops import degree
from ...sharding import constrain
from .common import init_mlp, layer_norm, mlp_apply, param_device

__all__ = ["AGGREGATORS", "PNAConfig", "SCALERS", "forward", "init_params"]

AGGREGATORS = ("mean", "max", "min", "std")
SCALERS = ("identity", "amplification", "attenuation")


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 16
    n_classes: int = 8
    delta: float = 2.5           # avg log-degree normalizer (dataset statistic)
    readout: str = "node"        # node | graph
    edge_chunks: int = 1         # PSW edge chunking for huge partitions


def init_params(gen, cfg: PNAConfig, device=None):
    gen, dev = param_device(gen, device)
    d = cfg.d_hidden
    n_ch = len(AGGREGATORS) * len(SCALERS)
    return {
        "encoder": init_mlp(gen, [cfg.d_in, d], dev),
        "layers": [{
            "pre": init_mlp(gen, [2 * d, d], dev),      # msg = MLP([h_u, h_v])
            "post": init_mlp(gen, [n_ch * d + d, d], dev),  # combine w/ self
        } for _ in range(cfg.n_layers)],
        "decoder": init_mlp(gen, [d, d, cfg.n_classes], dev),
    }


def forward(params, batch, cfg: PNAConfig):
    x = constrain(mlp_apply(params["encoder"], batch["x"], final_act=True),
                  "nodes", None)
    src, dst = batch["src"], batch["dst"]
    n = x.shape[0]
    deg = degree(torch.where(batch["edge_mask"].bool(), dst, n - 1), n)
    logd = torch.log1p(deg)[:, None]
    amp = logd / cfg.delta
    att = cfg.delta / torch.clamp(logd, min=1e-6)

    for lp in params["layers"]:
        def msg_fn(src, dsti, _x=x, _lp=lp):
            msg_in = torch.cat([_x[src], _x[dsti]], dim=-1)
            return mlp_apply(_lp["pre"], msg_in, final_act=True)

        acc = multi_aggregate_chunked(
            msg_fn,
            {"dst": dst, "mask": batch["edge_mask"], "src": src, "dsti": dst},
            n, cfg.d_hidden, AGGREGATORS, chunks=cfg.edge_chunks)
        agg = fold_aggregate(acc, AGGREGATORS).to(x.dtype)     # (N, 4d)
        scaled = torch.cat([agg, agg * amp, agg * att], -1)     # (N, 12d)
        scaled = constrain(scaled, "nodes", None)
        h = mlp_apply(lp["post"], torch.cat([x, scaled], -1))
        x = constrain(layer_norm(x + h), "nodes", None)

    if cfg.readout == "graph":
        pooled = (x * batch["node_mask"][:, None]).sum(0, keepdim=True)
        return mlp_apply(params["decoder"], pooled)
    return mlp_apply(params["decoder"], x)
