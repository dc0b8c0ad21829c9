"""Real spherical-harmonic rotation matrices (Wigner D in the real basis).
Port of the reference `repro/models/gnn/wigner.py`.

Ivanic & Ruedenberg recursion (J. Phys. Chem. 1996, with 1998 errata):
builds the (2l+1)x(2l+1) rotation of real SH coefficients for each l from
the l=1 matrix, batched over edges. This is the rotation step of eSCN /
EquiformerV2: rotate each edge's features into the edge-aligned frame where
the SO(2) convolution is m-sparse, then rotate back.

The reference writes each of the (2l+1)^2 entries of a level as its own
small sum of products over the edges, a few thousand elementwise ops for
l_max = 6. Here the same sums are read from index and coefficient tables:
per level, every helper P^l_{i,mu,mp} at once, one gather of the rows each
entry names, and three multiply-adds. The terms are the reference's, added
in its order; a term the reference leaves out enters with coefficient 0.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import List

import numpy as np
import torch

__all__ = ["wigner_rotations", "rotation_to_z", "blockdiag_apply",
           "irreps_dim"]


def irreps_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


def _uvw(l, m, mp):
    am = abs(m)
    if abs(mp) < l:
        denom = (l + mp) * (l - mp)
    else:
        denom = (2 * l) * (2 * l - 1)
    u = math.sqrt((l + m) * (l - m) / denom)
    d_m0 = 1.0 if m == 0 else 0.0
    v = 0.5 * math.sqrt((1 + d_m0) * (l + am - 1) * (l + am) / denom) * (1 - 2 * d_m0)
    w = -0.5 * math.sqrt((l - am - 1) * (l - am) / denom) * (1 - d_m0)
    return u, v, w


def _slots(l, m):
    """The five helpers entry row m sums, as ((i, mu), coefficient): P_0
    for u; the pair v multiplies; the pair w multiplies (the reference's
    `_recurse`, its signs folded into the coefficients)."""
    if m == 0:
        v = [((1, 1), 1.0), ((-1, -1), 1.0)]
    elif m > 0:
        d = 1.0 if m == 1 else 0.0
        v = [((1, m - 1), math.sqrt(1 + d)), ((-1, -m + 1), -(1 - d))]
    else:
        d = 1.0 if m == -1 else 0.0
        v = [((1, m + 1), 1 - d), ((-1, -m - 1), math.sqrt(1 + d))]
    if m > 0:
        w = [((1, m + 1), 1.0), ((-1, -m - 1), 1.0)]
    else:
        w = [((1, m - 1), 1.0), ((-1, -m + 1), -1.0)]
    return [((0, m), 1.0)] + v + w


@lru_cache(maxsize=None)
def _tables(l):
    """Level l's tables (numpy, cached, read by `_recurse` alone): rows
    (2l+1, 5) into the helpers flattened over (i, mu); coef (2l+1, 5); uvw
    (3, 2l+1, 2l+1) with 0 wherever the reference skips the term."""
    n, off = 2 * l + 1, l - 1
    rows = np.zeros((n, 5), np.int64)
    coef = np.zeros((n, 5), np.float64)
    uvw = np.zeros((3, n, n), np.float64)
    for a, m in enumerate(range(-l, l + 1)):
        for b, mp in enumerate(range(-l, l + 1)):
            uvw[:, a, b] = _uvw(l, m, mp)
        for s, ((i, mu), c) in enumerate(_slots(l, m)):
            if abs(mu) <= off:    # a helper outside the range has u/w = 0
                rows[a, s] = (i + 1) * (2 * l - 1) + mu + off
                coef[a, s] = c
    return rows, coef, uvw


def _helpers(Mlm1, M1, l):
    """P^l_{i,mu,mp} for every i in {-1,0,1}, |mu| < l, |mp| <= l:
    (..., 3, 2l-1, 2l+1), the reference's `_p_entry`."""
    a = M1[..., :, 2, None] * Mlm1[..., None, :, 2 * l - 2]
    b = M1[..., :, 0, None] * Mlm1[..., None, :, 0]
    c = M1[..., :, 2, None] * Mlm1[..., None, :, 0]
    d = M1[..., :, 0, None] * Mlm1[..., None, :, 2 * l - 2]
    mid = M1[..., :, 1, None, None] * Mlm1[..., None, :, :]
    return torch.cat([(c + d)[..., None], mid, (a - b)[..., None]], dim=-1)


def _recurse(Mlm1, M1, l):
    rows, coef, uvw = _tables(l)
    dev, dt = M1.device, M1.dtype
    P = _helpers(Mlm1, M1, l)
    P = P.reshape(*P.shape[:-3], 3 * (2 * l - 1), 2 * l + 1)
    G = P[..., torch.tensor(rows, device=dev), :]   # (..., 2l+1, 5, 2l+1)
    c = torch.tensor(coef, dtype=dt, device=dev)[..., None]
    u, v, w = torch.tensor(uvw, dtype=dt, device=dev)
    vv = G[..., 1, :] * c[:, 1] + G[..., 2, :] * c[:, 2]
    ww = G[..., 3, :] * c[:, 3] + G[..., 4, :] * c[:, 4]
    return u * G[..., 0, :] + v * vv + w * ww


def wigner_rotations(R: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """R: (..., 3, 3) rotation matrices -> [M_0, ..., M_lmax], each
    (..., 2l+1, 2l+1), rotating real SH coefficient vectors."""
    perm = torch.tensor([1, 2, 0], device=R.device)  # l=1 order (y, z, x)
    M1 = R[..., perm[:, None], perm[None, :]]
    mats = [torch.ones(R.shape[:-2] + (1, 1), dtype=R.dtype,
                       device=R.device), M1]
    for l in range(2, l_max + 1):
        mats.append(_recurse(mats[-1], M1, l))
    return mats[: l_max + 1]


def rotation_to_z(direction: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Rotation R with R @ d = z for unit vectors d: (..., 3).

    z is the principal axis of this real-SH convention (m=0 components are
    z-aligned; rotations about z mix only within (m, -m) pairs), so the
    SO(2) convolution's m-sparsity holds exactly in the aligned frame.
    Rodrigues formula with robust handling of d near +-z.
    """
    d = direction / torch.clamp(torch.linalg.norm(direction, dim=-1,
                                                  keepdim=True), min=eps)
    z = torch.zeros_like(d)
    z[..., 2] = 1.0
    v = torch.linalg.cross(d, z, dim=-1)
    c = d[..., 2]                              # cos = d . z
    s2 = torch.sum(v * v, dim=-1)              # sin^2
    # K = [v]_x ; R = I + K + K^2 (1-c)/s^2
    zeros = torch.zeros_like(c)
    K = torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zeros], -1),
    ], -2)
    eye = torch.eye(3, dtype=d.dtype, device=d.device).expand(K.shape)
    factor = torch.where(s2 > eps, (1.0 - c) / torch.clamp(s2, min=eps), 0.0)
    R = eye + K + factor[..., None, None] * (K @ K)
    # antiparallel (d = -z): rotate pi about x
    flip = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]],
                        dtype=d.dtype, device=d.device).expand(K.shape)
    anti = (c < -1.0 + 1e-6)[..., None, None]
    return torch.where(anti, flip, R)


def blockdiag_apply(mats: List[torch.Tensor], x: torch.Tensor,
                    transpose: bool = False) -> torch.Tensor:
    """Apply per-l rotations to stacked irreps features.

    mats[l]: (..., 2l+1, 2l+1); x: (..., (lmax+1)^2, C). Returns same shape.
    """
    outs = []
    o = 0
    for l, M in enumerate(mats):
        k = 2 * l + 1
        blk = x[..., o:o + k, :]
        Ml = M.transpose(-1, -2) if transpose else M
        outs.append(torch.matmul(Ml, blk))
        o += k
    return torch.cat(outs, dim=-2)
