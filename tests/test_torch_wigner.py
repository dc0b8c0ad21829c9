"""The port's Wigner algebra (repro_torch/models/gnn/wigner.py) against the
reference's (repro/models/gnn/wigner.py) on seeded numpy inputs, within
1e-5 (the reference's own Wigner tests hold 2e-5 and 1e-5), and the
reference's properties of the port's matrices: homomorphism,
orthogonality, the l=2 real harmonics."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import wigner as rw
from repro_torch.models.gnn import wigner as w

TOL = dict(rtol=1e-5, atol=1e-5)


def rotations(n, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


@pytest.mark.parametrize("l_max", [0, 1, 2, 4, 6])
def test_wigner_rotations_match_reference(l_max):
    R = rotations(64, l_max)
    want = rw.wigner_rotations(jnp.asarray(R), l_max)
    got = w.wigner_rotations(torch.from_numpy(R), l_max)
    assert len(got) == len(want) == l_max + 1
    for l, (a, b) in enumerate(zip(got, want)):
        assert tuple(a.shape) == (64, 2 * l + 1, 2 * l + 1)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("l_max", [2, 4, 6])
def test_homomorphism_and_orthogonality(l_max):
    R1, R2 = rotations(2, 10 + l_max)
    M1 = w.wigner_rotations(torch.from_numpy(R1), l_max)
    M2 = w.wigner_rotations(torch.from_numpy(R2), l_max)
    M12 = w.wigner_rotations(torch.from_numpy(R1 @ R2), l_max)
    for l in range(l_max + 1):
        np.testing.assert_allclose((M1[l] @ M2[l]).numpy(), M12[l].numpy(),
                                   atol=2e-5)
        np.testing.assert_allclose((M1[l] @ M1[l].T).numpy(),
                                   np.eye(2 * l + 1), atol=2e-5)


def test_l2_against_explicit_sh():
    R = rotations(1, 9)[0]
    M = w.wigner_rotations(torch.from_numpy(R), 2)[2].numpy()

    def Y2(v):
        x, y, z = v
        s15 = np.sqrt(15.0)
        return np.stack([s15 * x * y, s15 * y * z,
                         np.sqrt(5.0) / 2 * (3 * z * z - 1), s15 * x * z,
                         s15 / 2 * (x * x - y * y)])

    v = np.random.default_rng(10).standard_normal(3)
    v /= np.linalg.norm(v)
    np.testing.assert_allclose(Y2(R @ v), M @ Y2(v), atol=1e-5)


def directions():
    """Random directions, then +-z exactly, scaled, and within 1e-7 of
    them (where the Rodrigues factor's s2 > eps guard and the
    antiparallel flip decide)."""
    rng = np.random.default_rng(11)
    near = [[0, 0, 1], [0, 0, -1], [0, 0, 3.5], [0, 0, -0.25],
            [1e-7, 0, 1], [0, -1e-7, 1], [1e-7, 1e-7, -1], [-1e-7, 0, -1],
            [1e-4, 0, -1], [0, 1e-3, 1]]
    return np.concatenate([rng.standard_normal((40, 3)),
                           np.asarray(near)]).astype(np.float32)


def test_rotation_to_z_matches_reference():
    d = directions()
    want = np.asarray(rw.rotation_to_z(jnp.asarray(d)))
    got = w.rotation_to_z(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # R d = z, except at [1e-4, 0, -1] (row 48): within 1e-6 of -1 in
    # cos, the reference's flip takes over and misses z by 1e-4
    rows = np.delete(np.arange(len(d)), 48)
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.einsum("eij,ej->ei", got, dn)[rows],
                               np.tile([0.0, 0.0, 1.0], (len(rows), 1)),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    # exactly -z: the flip, a rotation by pi about x
    np.testing.assert_array_equal(got[41], np.diag([1.0, -1.0, -1.0]))


@pytest.mark.parametrize("transpose", [False, True])
def test_blockdiag_apply_matches_reference(transpose):
    l_max, C = 4, 6
    R = rotations(20, 12)
    x = np.random.default_rng(13).standard_normal(
        (20, w.irreps_dim(l_max), C)).astype(np.float32)
    want = rw.blockdiag_apply(rw.wigner_rotations(jnp.asarray(R), l_max),
                              jnp.asarray(x), transpose=transpose)
    mats = w.wigner_rotations(torch.from_numpy(R), l_max)
    got = w.blockdiag_apply(mats, torch.from_numpy(x), transpose=transpose)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # rotating back undoes the rotation
    back = w.blockdiag_apply(mats, got, transpose=not transpose)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
