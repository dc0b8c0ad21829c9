"""The port's checkpoints (repro_torch/checkpoint/manager.py) against the
reference's (repro/checkpoint/manager.py), on the CPU: a pytree saved by
one package restores in the other, bitwise, a bfloat16 leaf included; the
`.npy` members both packages write are the same bytes; `keep` prunes
alike; `save_lsm` / `restore_lsm` cross packages; and `restore()` with no
device raises where CUDA is absent."""
import collections
import os
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as R
from repro.checkpoint import manager as RM
import repro_torch.core as T
from repro_torch.checkpoint import manager as TM
from test_torch_disk import MAX_ID, coo, drive, same_coo

Pair = collections.namedtuple("Pair", "scale bias")


def arrays(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((5, 7)).astype(np.float32),
        "b": rng.standard_normal((3, 4)).astype(np.float32).astype(
            ml_dtypes.bfloat16),
        "k": rng.integers(-9, 9, 6).astype(np.int32),
        "s": np.asarray(rng.standard_normal(), np.float64),
        "p": rng.standard_normal(2).astype(np.float32),
    }


def ref_tree(a):
    return {"params": {"w": a["w"], "emb": a["b"]},
            "layers": [{"k": a["k"]}, (a["s"], None)],
            "norm": Pair(a["p"], None)}


def port_tree(a):
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()
         if k != "b"}
    t["b"] = torch.from_numpy(a["b"].view(np.int16).copy()).view(
        torch.bfloat16)
    return {"params": {"w": t["w"], "emb": t["b"]},
            "layers": [{"k": t["k"]}, (t["s"], None)],
            "norm": Pair(t["p"], None)}


def leaves(tree):
    """The five saved leaves of either package's tree, in one order."""
    return [tree["params"]["w"], tree["params"]["emb"], tree["layers"][0]["k"],
            tree["layers"][1][0], tree["norm"].scale]


def same_leaf(ref, port) -> bool:
    """Equal bytes, shapes and dtypes (bfloat16 by its 16-bit pattern)."""
    ref = np.asarray(ref)
    if port.dtype == torch.bfloat16:
        return (ref.dtype == ml_dtypes.bfloat16
                and np.array_equal(ref.view(np.int16),
                                   port.view(torch.int16).numpy()))
    got = port.numpy()
    return got.dtype == ref.dtype and np.array_equal(got, ref)


def test_pytree_keys_are_the_references():
    a = arrays(0)
    rk, _ = RM._flatten_with_paths(ref_tree(a))
    tk, _ = TM._flatten_with_paths(port_tree(a))
    assert sorted(tk) == sorted(rk)
    assert "['params']/['emb']" in tk and "['norm']/.scale" in tk
    assert "['layers']/[1]/[0]" in tk and len(tk) == 5


@pytest.mark.parametrize("blocking", [True, False])
def test_port_save_restores_in_the_reference(tmp_path, blocking):
    a = arrays(1)
    tm = TM.CheckpointManager(str(tmp_path / "ck"))
    tm.save(3, port_tree(a), blocking=blocking)
    tm.wait()
    tree, step = RM.CheckpointManager(str(tmp_path / "ck")).restore(
        ref_tree(arrays(2)))
    assert step == 3
    assert tree["layers"][1][1] is None and tree["norm"].bias is None
    for got, want in zip(leaves(tree), leaves(ref_tree(a))):
        assert np.asarray(got).dtype == want.dtype
        assert np.asarray(got).shape == want.shape
        assert np.asarray(got).tobytes() == want.tobytes()


def test_reference_save_restores_in_the_port(tmp_path):
    a = arrays(3)
    RM.CheckpointManager(str(tmp_path / "ck")).save(5, ref_tree(a))
    tree, step = TM.CheckpointManager(str(tmp_path / "ck")).restore(
        port_tree(arrays(4)), device="cpu")
    assert step == 5
    assert tree["layers"][1][1] is None and tree["norm"].bias is None
    assert isinstance(tree["norm"], Pair)
    for want, got in zip(leaves(ref_tree(a)), leaves(tree)):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert same_leaf(want, got)


def test_npy_members_are_the_same_bytes(tmp_path):
    a = arrays(5)
    RM.CheckpointManager(str(tmp_path / "r")).save(1, ref_tree(a))
    TM.CheckpointManager(str(tmp_path / "t")).save(1, port_tree(a))
    name = "step_0000000001.npz"
    with zipfile.ZipFile(tmp_path / "r" / name) as zr, \
            zipfile.ZipFile(tmp_path / "t" / name) as zt:
        assert sorted(zt.namelist()) == sorted(zr.namelist())
        for m in zr.namelist():
            assert zt.read(m) == zr.read(m), m
        assert b"'descr': '<V2'" in zt.read("['params']/['emb'].npy")


def test_keep_prunes_like_the_reference(tmp_path):
    a = arrays(6)
    for name, mod, tree in (("r", RM, ref_tree(a)), ("t", TM, port_tree(a))):
        m = mod.CheckpointManager(str(tmp_path / name), keep=2)
        for step in (10, 20, 30, 5):
            m.save(step, tree)
        assert m.latest_step() == 30
    for name in ("r", "t"):
        assert sorted(os.listdir(tmp_path / name)) == [
            "MANIFEST.json", "step_0000000020.npz", "step_0000000030.npz"]
    with pytest.raises(FileNotFoundError):
        TM.CheckpointManager(str(tmp_path / "empty")).restore(
            port_tree(a), device="cpu")


def test_restore_without_a_device_raises_when_cuda_is_absent(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means it")
    m = TM.CheckpointManager(str(tmp_path / "ck"))
    m.save(1, port_tree(arrays(7)))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.restore(port_tree(arrays(7)))


@pytest.mark.parametrize("writer", [R, T])
def test_save_lsm_restore_lsm_across_packages(tmp_path, writer):
    """A GraphDB (linked partition files, tombstones, RAM partitions, live
    buffers) saved by one package's `save_lsm` restores in the other's, and
    the same store saved by each package gives the same graph manifest."""
    save, restore = ((RM.save_lsm, TM.restore_lsm) if writer is R
                     else (TM.save_lsm, RM.restore_lsm))
    db = drive(writer, str(tmp_path / "db"), seed=9, n_chunks=3, tail=1500)
    assert any(len(b) for b in db.tree.buffers)
    m = save(db, str(tmp_path / "ck"))
    assert m["linked"] > 0 and m.get("buffers")
    tree = restore(str(tmp_path / "ck"))
    assert same_coo(coo(tree), coo(db))
    for v in range(0, MAX_ID + 1, 211):
        assert np.array_equal(tree.out_neighbors(v), db.out_neighbors(v))
        assert np.array_equal(tree.in_neighbors(v), db.in_neighbors(v))
    other = T if writer is R else R
    db2 = drive(other, str(tmp_path / "db2"), seed=9, n_chunks=3, tail=1500)
    m2 = (TM if writer is R else RM).save_lsm(db2, str(tmp_path / "ck2"))
    assert m2 == m
    assert sorted(os.listdir(tmp_path / "ck2")) == sorted(
        os.listdir(tmp_path / "ck"))


def test_save_lsm_copies_the_other_packages_partition_files(tmp_path):
    """`save_lsm` links only its own package's partition files: the port's
    save of a reference GraphDB writes `.npz` copies (ROADMAP note h),
    and they restore to the same graph."""
    db = drive(R, str(tmp_path / "db"), seed=10, n_chunks=3, tail=500)
    assert db._disk_partitions()
    m = TM.save_lsm(db, str(tmp_path / "ck"))
    assert m["linked"] == 0 and m["written"] > 0
    assert same_coo(coo(TM.restore_lsm(str(tmp_path / "ck"))), coo(db))
