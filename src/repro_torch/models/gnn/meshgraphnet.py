"""MeshGraphNet (Pfaff et al., arXiv:2010.03409): encode-process-decode with
15 message-passing blocks, d_hidden=128, 2-layer MLPs + LayerNorm, residual
edge and node updates, sum aggregation. Port of the reference
`repro/models/gnn/meshgraphnet.py`.

The reference's one `lax.scan` over stacked blocks is a loop over
`params["blocks"]`, and its chunk scan a loop over edge chunks.
`remat_blocks` is kept so the config equals the reference's (where it
selects `jax.checkpoint`); the port does not checkpoint blocks, so a
training step keeps every block's activations."""
from __future__ import annotations

import dataclasses

import torch

from ...graph.segment_ops import scatter_sum
from ...sharding import constrain, unflatten
from .common import init_mlp, layer_norm, mlp_apply, param_device

__all__ = ["MeshGraphNetConfig", "forward", "init_params"]


@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 16
    d_edge_in: int = 8
    d_out: int = 3
    edge_chunks: int = 1         # PSW edge chunking for huge partitions
    remat_blocks: bool = False   # checkpoint processor blocks (huge graphs)


def _mlp_dims(cfg, d_in):
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers


def init_params(gen, cfg: MeshGraphNetConfig, device=None):
    gen, dev = param_device(gen, device)
    return {
        "node_encoder": init_mlp(gen, _mlp_dims(cfg, cfg.d_node_in), dev),
        "edge_encoder": init_mlp(gen, _mlp_dims(cfg, cfg.d_edge_in), dev),
        "blocks": [{
            "edge_mlp": init_mlp(gen, _mlp_dims(cfg, 3 * cfg.d_hidden), dev),
            "node_mlp": init_mlp(gen, _mlp_dims(cfg, 2 * cfg.d_hidden), dev),
        } for _ in range(cfg.n_layers)],
        "decoder": init_mlp(gen, [cfg.d_hidden, cfg.d_hidden, cfg.d_out],
                            dev),
    }


def forward(params, batch, cfg: MeshGraphNetConfig):
    src, dst = batch["src"], batch["dst"]
    emask = batch["edge_mask"].to(torch.float32)[:, None]
    n = batch["x"].shape[0]

    h = layer_norm(mlp_apply(params["node_encoder"], batch["x"],
                             final_act=True))
    e = layer_norm(mlp_apply(params["edge_encoder"], batch["edge_attr"],
                             final_act=True))
    h = constrain(h, "nodes", None)
    e = constrain(e, "edges", None)

    nc = cfg.edge_chunks
    if nc < 1 or e.shape[0] % nc:
        raise ValueError(f"{e.shape[0]} edges do not split into {nc} chunks")

    def ch(a):
        return constrain(unflatten(a, 0, (nc, a.shape[0] // nc)),
                         None, "edges", *([None] * (a.ndim - 1)))

    for blk in params["blocks"]:
        if nc == 1:
            e_in = torch.cat([e, h[src], h[dst]], dim=-1)
            e = layer_norm(e + mlp_apply(blk["edge_mlp"], e_in,
                                         final_act=True)) * emask
            agg = scatter_sum(e, dst, n)
        else:
            chunks = {"e": ch(e), "src": ch(src), "dst": ch(dst),
                      "m": ch(batch["edge_mask"].to(e.dtype))}
            agg = torch.zeros((n, e.shape[-1]), dtype=torch.float32,
                              device=e.device)
            e_new = []
            for i in range(nc):
                c = {k: v[i] for k, v in chunks.items()}
                e_in = torch.cat([c["e"], h[c["src"]], h[c["dst"]]], -1)
                ei = layer_norm(c["e"] + mlp_apply(blk["edge_mlp"], e_in,
                                                   final_act=True)) \
                    * c["m"][:, None]
                agg = agg + scatter_sum(ei, c["dst"], n)
                e_new.append(ei)
            e = torch.cat(e_new).reshape(e.shape)
        n_in = torch.cat([h, agg], dim=-1)
        h = layer_norm(h + mlp_apply(blk["node_mlp"], n_in, final_act=True))
        h = constrain(h, "nodes", None)
        e = constrain(e, "edges", None)

    return mlp_apply(params["decoder"], h)
