"""The edge set of a live store after a prefix of its writes, from the raw
edge list and the run's own log of the writes it sent: plain torch, on the
device the tensors are on.

A key is a packed `src * n + dst` in original ids. The semantics:
  * the generated edges' distinct keys are present at the start (a
    repeated edge is one key);
  * an insert makes its key present, a delete makes it absent (a delete
    removes every copy of its key), an update of an edge's column changes
    no key's presence;
  * so a key's presence after a prefix of the writes is its last insert or
    delete in the prefix, where it has one, and its presence at the start
    where it has none;
  * every copy of an edge carries a time: an insert gives its new copy the
    time it was sent with, an update sets the time of the key's newest live
    copy (the one inserted last) and does nothing where the key has none.

Imports torch alone: nothing of the program under test.
"""
from __future__ import annotations

import torch

from .fof import EdgeIndex

INSERT, UPDATE, DELETE = 1, 0, -1


def key_set(base: torch.Tensor, keys: torch.Tensor, kind: torch.Tensor,
            upto: int) -> torch.Tensor:
    """The sorted present keys after the first `upto` writes. `base`: the
    distinct keys at the start, sorted; `keys`, `kind`: the writes in the
    order sent, kind 1 for an insert, -1 for a delete, 0 for an update."""
    keys, kind = keys[:upto], kind[:upto]
    structural = kind != 0
    keys, kind = keys[structural], kind[structural]
    if keys.shape[0] == 0:
        return base
    touched, inverse = torch.unique(keys, return_inverse=True)
    order = torch.arange(keys.shape[0], device=keys.device)
    last = torch.full(touched.shape, -1, dtype=torch.int64,
                      device=keys.device).scatter_reduce_(
        0, inverse, order, reduce="amax")
    present = kind[last] == INSERT
    kept = base[~torch.isin(base, touched)]
    return torch.sort(torch.cat([kept, touched[present]])).values


def edge_index(keys: torch.Tensor, n: int) -> EdgeIndex:
    """`reference.fof.EdgeIndex` of sorted distinct keys over n vertices."""
    tails = keys // n
    ptr = torch.searchsorted(
        tails, torch.arange(n + 1, device=keys.device, dtype=torch.int64))
    return EdgeIndex(n, ptr, keys % n)


def keys_differing(got: torch.Tensor, want: torch.Tensor) -> int:
    """How many keys are in one of the two key sets and not in the other;
    `got` may hold a key more than once (a repeated edge)."""
    got = torch.unique(got)
    return int(got.shape[0] + want.shape[0]
               - 2 * torch.isin(got, want).sum())


def written_times(base: torch.Tensor, keys: torch.Tensor, kind: torch.Tensor,
                  times: torch.Tensor, upto: int):
    """(keys, times), sorted by key and then time, of every live copy whose
    time a write set, after the first `upto` writes: the log replayed key
    by key, a copy at a time. `times` holds each write's time (a delete's
    is not read); the generated edges' copies carry no written time."""
    keys, kind, times = keys[:upto], kind[:upto], times[:upto]
    touched = torch.unique(keys)
    at_start = dict(zip(touched.tolist(),
                        torch.isin(touched, base).tolist()))
    copies = {}
    for k, c, t in zip(keys.tolist(), kind.tolist(), times.tolist()):
        held = copies.get(k)
        if held is None:
            # the generated copies, as one: only the newest is ever updated
            held = copies[k] = [None] if at_start[k] else []
        if c == INSERT:
            held.append(t)
        elif c == DELETE:
            held.clear()
        elif held:
            held[-1] = t
    pairs = sorted((k, t) for k, held in copies.items() for t in held
                   if t is not None)
    out = torch.tensor(pairs, dtype=torch.int64,
                       device=keys.device).reshape(-1, 2)
    return out[:, 0], out[:, 1]


def pairs_differing(got_keys: torch.Tensor, got_times: torch.Tensor,
                    want_keys: torch.Tensor, want_times: torch.Tensor) -> int:
    """How many (key, time) pairs the two multisets do not share: a pair
    held twice on one side and once on the other counts once."""
    both = torch.stack([torch.cat([got_keys, want_keys]),
                        torch.cat([got_times, want_times])])
    if both.shape[1] == 0:
        return 0
    _, inverse = torch.unique(both, dim=1, return_inverse=True)
    side = torch.cat([torch.ones_like(got_keys), -torch.ones_like(want_keys)])
    net = torch.zeros(int(inverse.max()) + 1, dtype=torch.int64,
                      device=both.device).index_add_(0, inverse, side)
    return int(net.abs().sum())
