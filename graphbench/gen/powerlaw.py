"""Directed power-law graphs shaped by a configuration's source, made from a seed.

The degree sequences are fixed by the configuration alone (no randomness):
Chung-Lu weights `w_i = c (i + i0) ** (-1 / (exponent - 1))` over the ranks
`i = 0 .. n - 1`, with `i0` and `c` chosen so that the top rank has the
configuration's largest degree and the weights sum to the edge count, then
rounded to whole degrees that keep that sum. So every seed gets the same
degrees; the seed decides which vertex holds which rank and how the edges
are wired.

From the seed, on `device` with one `torch.Generator`:
  * each vertex gets an out-rank and an in-rank, correlated through a
    Gaussian copula of correlation `degree_rank_correlation` (1: the
    largest out-degree is also the largest in-degree);
  * a configuration-model draw pairs out-stubs with shuffled in-stubs,
    `_OVERDRAW` times as many as needed; self-loops and repeated pairs are
    dropped and a uniform subset of the simple edges is kept;
  * a share `duplicate_share` of the edges is then drawn again (repeated
    follows: multi-edges) and a share `self_loop_share` of vertices link to
    themselves, so that the store's semantics for both are exercised.

Every seed gives every class of ids modulo `id_classes` the same in-edge
count, a departure from the source that the configuration states under
`assumed`: the vertex of in-rank r gets an id congruent to r (the ranks are
dealt round-robin, a random id within each class), and the simple edges,
repeats and self-loops are each dealt to the classes of their destination
in equal numbers. Otherwise the seed would decide how evenly the hubs fall
on the classes.

The edges come back as int64 tensors on `device` in a random order.
"""
from __future__ import annotations

import dataclasses

import torch

# stubs drawn beyond the simple edges kept, to cover the self-loops and
# repeated pairs that the configuration model makes between hubs
_OVERDRAW = 1.15


@dataclasses.dataclass(frozen=True)
class GraphShape:
    vertices: int
    edges: int
    out_exponent: float
    in_exponent: float
    max_out_degree: int
    max_in_degree: int
    degree_rank_correlation: float
    duplicate_share: float
    self_loop_share: float
    id_classes: int

    @classmethod
    def from_config(cls, cfg: dict) -> "GraphShape":
        a = cfg["assumed"]
        return cls(int(cfg["vertices"]), int(cfg["edges"]),
                   float(a["out_exponent"]), float(a["in_exponent"]),
                   int(a["max_out_degree"]), int(a["max_in_degree"]),
                   float(a["degree_rank_correlation"]),
                   float(a["duplicate_share"]), float(a["self_loop_share"]),
                   int(a["id_classes"]))

    @property
    def n_duplicates(self) -> int:
        return int(round(self.duplicate_share * self.edges))

    @property
    def n_self_loops(self) -> int:
        return int(round(self.self_loop_share * self.edges))

    @property
    def simple_edges(self) -> int:
        return self.edges - self.n_duplicates - self.n_self_loops


def degree_sequence(n: int, total: int, exponent: float, max_degree: int,
                    device="cpu") -> torch.Tensor:
    """(n,) int64 degrees on `device`, descending, summing to `total`, the
    first one `max_degree` (up to rounding): Chung-Lu power-law weights."""
    if not 0 < max_degree <= total or n < 1:
        raise ValueError(f"no power law of {n} vertices, {total} edges and "
                         f"largest degree {max_degree}")
    a = 1.0 / (exponent - 1.0)
    ranks = torch.arange(n, dtype=torch.float64, device=device)
    target = max_degree / total
    lo, hi = 1e-9, float(n) * 1e3
    for _ in range(100):          # the top rank's share falls as i0 grows
        i0 = (lo * hi) ** 0.5
        w = (ranks + i0) ** -a
        if float(w[0] / w.sum()) > target:
            lo = i0
        else:
            hi = i0
    w = (ranks + (lo * hi) ** 0.5) ** -a
    w *= total / w.sum()
    deg = torch.floor(w).to(torch.int64)
    short = int(total - int(deg.sum()))
    if short:                     # the largest remainders round up
        order = torch.argsort(-(w - deg), stable=True)
        deg[order[:short]] += 1
    return torch.sort(deg, descending=True, stable=True).values


def _ranks(score: torch.Tensor) -> torch.Tensor:
    """rank[v] = position of v when the scores are sorted, largest first."""
    order = torch.argsort(score, descending=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return rank


def generate(shape: GraphShape, seed: int, device) -> tuple:
    """(src, dst) int64 tensors on `device`: `shape.edges` directed edges
    over vertices 0 .. shape.vertices - 1, made from `seed` alone."""
    dev = torch.device(device)
    n = shape.vertices
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    drawn = int(shape.simple_edges * _OVERDRAW)
    # the subset kept thins every degree by about the overdraw, the largest
    # too, so the draw's largest degrees are raised by as much
    out_deg = degree_sequence(n, drawn, shape.out_exponent,
                              round(shape.max_out_degree * _OVERDRAW), dev)
    in_deg = degree_sequence(n, drawn, shape.in_exponent,
                             round(shape.max_in_degree * _OVERDRAW), dev)

    rho = shape.degree_rank_correlation
    z = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    z2 = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    out_rank = _ranks(z)
    in_rank = _ranks(rho * z + (1.0 - rho * rho) ** 0.5 * z2)
    del z, z2
    ids = _dealt_ids(n, shape.id_classes, gen)[in_rank]
    by_out = ids[torch.argsort(out_rank)]     # id holding out-rank i
    by_in = ids[torch.argsort(in_rank)]
    src = torch.repeat_interleave(by_out, out_deg)
    dst = torch.repeat_interleave(by_in, in_deg)
    dst = dst[torch.randperm(drawn, generator=gen, device=dev)]
    del by_out, by_in, out_deg, in_deg

    keys = src * n + dst
    del src, dst
    keys = torch.unique(keys[(keys // n) != (keys % n)])   # simple edges
    P = shape.id_classes
    quota = _shares(shape.simple_edges, P, dev)
    keys = keys[_dealt(keys % n % P, quota, gen)]   # grouped by class
    start = torch.cumsum(quota, 0) - quota
    n_dup = _shares(shape.n_duplicates, P, dev)
    part = torch.repeat_interleave(torch.arange(P, device=dev), n_dup)
    pick = start[part] + (torch.rand(part.shape[0], generator=gen,
                                     device=dev, dtype=torch.float64)
                          * quota[part]).to(torch.int64)
    dup = keys[pick]
    part = torch.repeat_interleave(torch.arange(P, device=dev),
                                   _shares(shape.n_self_loops, P, dev))
    in_part = (n - part + P - 1) // P          # vertices of each class
    v = part + P * (torch.rand(part.shape[0], generator=gen, device=dev,
                               dtype=torch.float64) * in_part
                    ).to(torch.int64)
    keys = torch.cat([keys, dup, v * (n + 1)])
    del dup, v, part, pick
    keys = keys[torch.randperm(keys.shape[0], generator=gen, device=dev)]
    return keys // n, keys % n


def relabelling(n: int, parts: int, seed: int, device) -> torch.Tensor:
    """labels[v]: a permutation of 0 .. n - 1 made from `seed`, with
    labels[v] = v (mod parts). Applied to a graph from `generate`, it keeps
    every class of ids, and so every partition of the store, holding the
    same vertices' degrees."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) % (2 ** 63))
    return _dealt_ids(n, parts, gen)


def _dealt_ids(n: int, parts: int, gen: torch.Generator) -> torch.Tensor:
    """ids[r]: a permutation of 0 .. n - 1 with ids[r] = r (mod parts),
    random within each class."""
    r = torch.arange(n, device=gen.device)
    cls = r % parts
    order = torch.argsort(cls.to(torch.float64) + torch.rand(
        n, generator=gen, device=gen.device, dtype=torch.float64))
    count = torch.bincount(cls, minlength=parts)
    pos = torch.empty_like(r)
    pos[order] = r - (torch.cumsum(count, 0) - count)[cls[order]]
    return parts * pos + cls


def _shares(total: int, parts: int, device) -> torch.Tensor:
    """`total` split into `parts` whole shares that differ by one at most."""
    share = torch.full((parts,), total // parts, dtype=torch.int64,
                       device=device)
    share[: total % parts] += 1
    return share


def _dealt(group: torch.Tensor, quota: torch.Tensor,
           gen: torch.Generator) -> torch.Tensor:
    """Indices of a uniform choice of `quota[g]` items of each group `g`,
    grouped by `g` in ascending order."""
    noise = torch.rand(group.shape[0], generator=gen, device=group.device,
                       dtype=torch.float64)
    order = torch.argsort(group.to(torch.float64) + noise)
    have = torch.bincount(group, minlength=quota.shape[0])
    if bool((have < quota).any()):
        raise ValueError(f"a class has fewer simple edges ({have.tolist()})"
                         f" than its share ({quota.tolist()})")
    g = group[order]
    pos = torch.arange(order.shape[0], device=group.device) \
        - (torch.cumsum(have, 0) - have)[g]
    return order[pos < quota[g]]


def degree_summary(src: torch.Tensor, dst: torch.Tensor, n: int,
                   id_classes: int) -> dict:
    """Largest in- and out-degree, self-loops, repeated pairs and the
    fewest and most in-edges of a class of ids, of an edge list, for the
    run's log."""
    per_class = torch.bincount(dst % id_classes, minlength=id_classes)
    out_deg = torch.bincount(src, minlength=n)
    in_deg = torch.bincount(dst, minlength=n)
    keys = src * n + dst
    distinct = int(torch.unique(keys).shape[0])
    return {"vertices": n, "edges": int(src.shape[0]),
            "max_out_degree": int(out_deg.max()),
            "max_in_degree": int(in_deg.max()),
            "self_loops": int((src == dst).sum()),
            "repeated_edges": int(src.shape[0]) - distinct,
            "class_in_edges": [int(per_class.min()), int(per_class.max())]}
