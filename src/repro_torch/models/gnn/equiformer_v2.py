"""EquiformerV2 (Liao et al., arXiv:2306.12059): equivariant graph attention
with eSCN-style SO(2) convolutions. Port of the reference
`repro/models/gnn/equiformer_v2.py`.

Per edge: rotate source irreps (l <= l_max) into the edge-aligned frame with
real-basis Wigner matrices, apply the m-sparse SO(2) linear map (m <= m_max,
the eSCN O(L^6) -> O(L^3) reduction), gate by radial features, weight by
multi-head attention from invariant (m=0) channels, rotate back, scatter-sum
to destinations. Equivariant LayerNorm + gated nonlinearity + per-l FFN.

Features: (N, (l_max+1)^2, C). Large graphs are processed with
`edge_chunks > 1`: a first chunked pass computes attention logits (per-edge
scalars only), softmax normalises globally, a second chunked pass computes
and scatters the messages: two sweeps over the edge partitions, the PSW
discipline.

The scatter of a chunk's messages into destinations is A @ msg, A the
(n x E_chunk) incidence matrix of the chunk's live edges, so it runs on the
psw_spmm kernel: one `prepare_rows` layout a chunk, built once a forward
before the layer loop, and one `psw_spmm_rows` a chunk and layer, which
launches the kernel for CUDA tensors (or raises; it never drops to the
plain version) and takes its plain version for CPU tensors; its backward
runs the same kernel over each chunk layout's transpose, built once a
forward. A masked edge
(padding, or zero length) is left out of the layout where the reference
multiplies its message by 0: finite messages give the same sums, and a
non-finite message of a masked edge reaches nothing (ROADMAP queue 3,
caveat e).

`gather_mode="psw_ring"` gathers source rows around the `torch.distributed`
ring of `graph/psw_ops.py`, in bfloat16 as the reference does. The batch is
then this rank's shard: species, pos and node_mask of its n_loc nodes
(global rows rank * n_loc ...), src / dst / edge_mask of its edges with
global node ids, every dst owned by the rank (PAL; the reference clips
others, and so does the port). The forward returns the rank's (n_loc,
d_out) rows; on one rank, the whole batch's. The reference's `lax.scan`
over layers and chunks are Python loops; its `jax.checkpoint`s
(`remat_layers`, and each chunk's pass when `edge_chunks > 1`) are
`torch.utils.checkpoint` while grad is on and nothing under `no_grad`.
The reference's `constrain`s sit where it has them, no-ops on one
device (`repro_torch.sharding`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...graph.psw_ops import (local_edge_softmax, local_gather, ring_gather,
                              ring_mesh)
from ...graph.segment_ops import edge_softmax
from ...kernels.psw_spmm.ops import prepare_rows, psw_spmm_rows
from ...sharding import constrain
from .common import init_mlp, mlp_apply, param_device
from .wigner import blockdiag_apply, irreps_dim, rotation_to_z, wigner_rotations

__all__ = ["EquiformerV2Config", "forward", "init_params", "message_scatterer"]


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_species: int = 32       # atom-type vocabulary
    n_rbf: int = 32
    cutoff: float = 5.0
    d_out: int = 1            # invariant output width
    edge_chunks: int = 1      # >1: two-pass chunked edge processing
    gather_mode: str = "take"  # take | psw_ring (DESIGN.md §2 ring windows)
    remat_layers: bool = False  # checkpoint whole layers (huge graphs)


def _l_slices(l_max: int):
    out, o = [], 0
    for l in range(l_max + 1):
        out.append((l, o, o + 2 * l + 1))
        o += 2 * l + 1
    return out


def _m0_index(l_max: int):
    """Index of the m=0 component of each l in the stacked irreps."""
    return [l * l + l for l in range(l_max + 1)]


def init_params(gen, cfg: EquiformerV2Config, device=None):
    gen, dev = param_device(gen, device)
    L, C, H = cfg.l_max, cfg.d_hidden, cfg.n_heads
    n_l = L + 1

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev) * scale

    layers = []
    for _ in range(cfg.n_layers):
        so2 = {"m0": normal((n_l, C, n_l, C), (n_l * C) ** -0.5)}
        for m in range(1, cfg.m_max + 1):
            lm = L + 1 - m
            so2[f"m{m}_r"] = normal((lm, C, lm, C), (lm * C) ** -0.5)
            so2[f"m{m}_i"] = normal((lm, C, lm, C), (lm * C) ** -0.5)
        layers.append({
            "so2": so2,
            "radial": init_mlp(gen, [cfg.n_rbf, C, n_l * C], dev),
            "attn": init_mlp(gen, [2 * n_l * C + cfg.n_rbf, C, H], dev),
            "ln_scale": torch.ones((n_l, C), device=dev),
            "gate": init_mlp(gen, [C, C, L * C], dev),   # gates for l>=1
            "ffn": {"w1": normal((n_l, C, C), C ** -0.5),
                    "w2": normal((n_l, C, C), C ** -0.5)},
        })
    return {
        "embed": normal((cfg.n_species, C), 0.02),
        "layers": layers,
        "out_head": init_mlp(gen, [C, C, cfg.d_out], dev),
    }


def _rbf(dist, cfg: EquiformerV2Config):
    centers = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, device=dist.device)
    gamma = cfg.n_rbf / cfg.cutoff
    return torch.exp(-gamma * (dist[..., None] - centers) ** 2)


def _equiv_layer_norm(x, scale, l_max, eps=1e-6):
    """Normalise each l-block by its RMS over (m, channel); learnable per
    (l, channel) scale. Equivariant: the norm is rotation-invariant."""
    outs = []
    for l, a, b in _l_slices(l_max):
        blk = x[:, a:b]
        rms = torch.sqrt(torch.mean(blk * blk, dim=(1, 2), keepdim=True)
                         + eps)
        outs.append(blk / rms * scale[l][None, None, :])
    return torch.cat(outs, dim=1)


def _mix(x, w):
    """einsum("elc,lckd->ekd", x, w): one (E, n*C) x (n*C, n*C) product."""
    E, n, C = x.shape
    return (x.reshape(E, n * C) @ w.reshape(n * C, n * C)).reshape(E, n, C)


def _so2_conv(xr, so2, radial_gate, cfg: EquiformerV2Config):
    """m-sparse SO(2) linear map in the edge-aligned frame.

    xr: (E, K, C) rotated irreps. radial_gate: (E, n_l, C) per-(l,channel)
    distance modulation. Output has only m <= m_max populated (eSCN
    truncation).
    """
    L = cfg.l_max
    out = torch.zeros_like(xr)
    # m = 0: one row per l
    m0_idx = _m0_index(L)
    out[:, m0_idx] = _mix(xr[:, m0_idx], so2["m0"]) * radial_gate
    # m >= 1: complex pairs (c_{l,+m}, c_{l,-m})
    for m in range(1, cfg.m_max + 1):
        ls = range(m, L + 1)
        ip = [l * l + l + m for l in ls]
        im = [l * l + l - m for l in ls]
        cr, ci = xr[:, ip], xr[:, im]                   # (E, lm, C)
        wr, wi = so2[f"m{m}_r"], so2[f"m{m}_i"]
        yr = _mix(cr, wr) - _mix(ci, wi)
        yi = _mix(cr, wi) + _mix(ci, wr)
        gate_m = radial_gate[:, m:]                     # reuse l-major rows
        out[:, ip] = yr * gate_m
        out[:, im] = yi * gate_m
    return out


def _edge_logits(xs, xd, lp, cfg, mats, rbf, emask):
    """Attention logits for a chunk of (pre-gathered) edges: (Ec, H)."""
    m0_idx = _m0_index(cfg.l_max)
    xr = blockdiag_apply(mats, xs.to(torch.float32))
    inv_s = xr[:, m0_idx].reshape(xr.shape[0], -1)
    xdr = blockdiag_apply(mats, xd.to(torch.float32))
    inv_d = xdr[:, m0_idx].reshape(xr.shape[0], -1)
    logits = mlp_apply(lp["attn"], torch.cat([inv_s, inv_d, rbf], -1))
    return torch.where(emask[:, None], logits, float("-inf"))


def _edge_messages(xs, lp, cfg, mats, rbf, alpha):
    """Attention-weighted eSCN messages for a chunk: (Ec, K, C). A masked
    edge's message is left as it is: the scatter's layout leaves it out."""
    L, C, H = cfg.l_max, cfg.d_hidden, cfg.n_heads
    K = irreps_dim(L)
    xr = blockdiag_apply(mats, xs.to(torch.float32))
    radial = mlp_apply(lp["radial"], rbf, final_act=False)
    radial_gate = torch.sigmoid(radial).reshape(-1, L + 1, C)
    msg_r = _so2_conv(xr, lp["so2"], radial_gate, cfg)
    msg = blockdiag_apply(mats, msg_r, transpose=True)  # rotate back
    msg = msg.reshape(msg.shape[0], K, H, C // H)
    msg = msg * alpha[:, None, :, None]
    return msg.reshape(msg.shape[0], K, C)


def _remat(fn, *args):
    """fn(*args), recomputed in the backward (jax.checkpoint) while grad is
    on."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def message_scatterer(emask, dst, chunks, n: int, device):
    """scatter(msg, c): edge chunk c's messages (Ec, K, C) summed into
    their destination rows, (n, K, C), on psw_spmm. One `prepare_rows`
    layout a chunk, built here, once a forward: rows the destinations
    `dst` (rank-local in psw_ring mode), sources the chunk's live edges
    (`emask`), so a masked edge's message reaches nothing."""
    layouts = []
    for sl in chunks:
        live = torch.nonzero(emask[sl]).flatten()
        layouts.append(prepare_rows(live, dst[sl][live], n, device=device,
                                    n_src=sl.stop - sl.start))

    def scatter(msg, c):
        m, K, C = msg.shape
        return psw_spmm_rows(layouts[c], msg.reshape(m, K * C)).reshape(
            n, K, C)

    return scatter


def forward(params, batch, cfg: EquiformerV2Config, ring=None):
    """batch: species (N,) int, pos (N, 3), src/dst (E,), edge_mask,
    node_mask. Returns (N, d_out) invariant predictions. In psw_ring mode
    the batch is this rank's shard (module docstring) and `ring` a
    `psw_ops.Ring` (None: `ring_mesh` of the default process group, or one
    rank)."""
    L, C = cfg.l_max, cfg.d_hidden
    K = irreps_dim(L)
    species, pos = batch["species"], batch["pos"]
    src, dst = batch["src"].long(), batch["dst"].long()
    emask = batch["edge_mask"].bool()
    n = species.shape[0]
    E = src.shape[0]
    dev = pos.device

    nc = cfg.edge_chunks
    if nc < 1 or E % nc:
        raise ValueError(f"{E} edges do not split into {nc} chunks")
    if cfg.gather_mode not in ("take", "psw_ring"):
        raise ValueError(f"gather_mode {cfg.gather_mode!r}: take | psw_ring")
    psw = cfg.gather_mode == "psw_ring"
    if psw:
        ring = ring_mesh(n) if ring is None else ring
        if ring.n_loc != n:
            raise ValueError(f"psw_ring needs a ring of {n} rows a rank "
                             f"(this rank's nodes); got {ring.n_loc}")
        n_glob = ring.n
        d_loc = torch.clamp(dst - ring.rank * n, 0, n - 1)
    else:
        d_loc = dst

    x = F.pad(params["embed"][species.long()][:, None, :], (0, 0, 0, K - 1))
    x = constrain(x, "nodes", None, None)

    # geometry is an input, not a parameter: no gradient reaches it, so
    # autograd never builds the Wigner recursion's backward
    with torch.no_grad():
        if psw:
            rel = ring_gather(pos, src, ring) - local_gather(pos, dst, ring)
        else:
            rel = pos[src] - pos[dst]
        dist = torch.linalg.norm(rel, dim=-1)
        # zero-length edges (self-loops / padding) carry no direction: mask
        # them (a radius graph has none; required for exact equivariance)
        emask = emask & (dist > 1e-8)
        safe_rel = torch.where(emask[:, None], rel,
                               torch.tensor([0.0, 0.0, 1.0], device=dev))
        R = rotation_to_z(safe_rel)                      # (E, 3, 3)
        mats = [constrain(m, "edges", None, None)
                for m in wigner_rotations(R, L)]
        rbf = _rbf(dist, cfg) * emask[:, None]

    Ec = E // nc
    chunks = [slice(c * Ec, (c + 1) * Ec) for c in range(nc)]
    scatter = message_scatterer(emask, d_loc, chunks, n, dev)

    def layer(x, lp):
        # gather once per layer: remote sources via the PSW ring; local
        # destinations (PAL guarantee) are gathered per chunk
        if psw:
            # bf16 through the ring: halves the ring's bytes and the
            # per-edge gathered state
            xb = x.to(torch.bfloat16)
            xs_all = ring_gather(xb, src, ring)
        else:
            xb = x
            xs_all = x[src]
        xs_all = constrain(xs_all, "edges", None, None)

        def gather_d(dst_c):
            return local_gather(xb, dst_c, ring) if psw else x[dst_c]

        if nc == 1:
            logits = _edge_logits(xs_all, gather_d(dst), lp, cfg, mats, rbf,
                                  emask)
        else:
            def logits_chunk(xs, dst_c, mats_c, rbf_c, emask_c):
                return _edge_logits(xs, gather_d(dst_c), lp, cfg, mats_c,
                                    rbf_c, emask_c)

            logits = torch.cat([
                _remat(logits_chunk, xs_all[sl], dst[sl],
                       [m[sl] for m in mats], rbf[sl], emask[sl])
                for sl in chunks])
        if psw:
            alpha = local_edge_softmax(logits, dst, n_glob, ring)
        else:
            alpha = edge_softmax(logits, dst, n)            # (E, H)
        alpha = torch.where(emask[:, None], alpha, 0.0)

        if nc == 1:
            msg = _edge_messages(xs_all, lp, cfg, mats, rbf, alpha)
            return scatter(msg, 0)
        agg = torch.zeros((n, K, C), dtype=torch.float32, device=dev)
        for c, sl in enumerate(chunks):
            msg = _remat(lambda *a: _edge_messages(a[0], lp, cfg, *a[1:]),
                         xs_all[sl], [m[sl] for m in mats], rbf[sl],
                         alpha[sl])
            agg = agg + scatter(msg, c)
        return agg

    def full_layer(x, lp):
        agg = layer(x, lp)
        x = x + agg
        x = _equiv_layer_norm(x, lp["ln_scale"], L)

        # gated equivariant FFN: per-l channel mixing
        h_blocks = [x[:, a:b] @ lp["ffn"]["w1"][l]
                    for l, a, b in _l_slices(L)]
        inv = F.silu(h_blocks[0][:, 0])                  # (N, C) invariant
        gates = torch.sigmoid(mlp_apply(lp["gate"], inv)).reshape(n, L, C)
        outs = []
        for l, a, b in _l_slices(L):
            blk = h_blocks[l]
            if l == 0:
                blk = F.silu(blk)
            else:
                blk = blk * gates[:, l - 1][:, None, :]
            outs.append(blk @ lp["ffn"]["w2"][l])
        return constrain(x + torch.cat(outs, dim=1), "nodes", None, None)

    for lp in params["layers"]:
        x = _remat(full_layer, x, lp) if cfg.remat_layers else \
            full_layer(x, lp)

    inv_out = x[:, 0]                                   # l=0 invariant channel
    return mlp_apply(params["out_head"], inv_out)
