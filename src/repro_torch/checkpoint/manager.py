"""Sharded, immutable, resumable checkpoints.

Design (mirrors the paper's crash-integrity argument, §7.3): every artifact
is an immutable flat file; a checkpoint is a manifest pointing at files; the
manifest is written LAST via atomic rename, so a crash mid-save can never
corrupt a restorable state — at worst the newest checkpoint is absent and
the previous manifest still points at complete files.

Features:
  * pytree save/restore as npz (one file per step by default; per-shard
    splitting hook for multi-host),
  * async save (background thread) so the train loop doesn't stall,
  * restore onto any device: leaves come back as torch tensors on the
    device the caller names (the GPU by default),
  * LSM graph checkpoints are INCREMENTAL: partitions are immutable, so only
    partitions not already in the store are written (content-addressed by
    (level, index, n_edges, hash)).

Port of the reference `repro/checkpoint/manager.py`. The pytree walk is
`torch.utils._pytree`'s, and each leaf is saved under the reference's key
(`"/".join(str(p) for p in path)`: `['a']`, `[0]`, `.name`), so a
checkpoint written by either package restores in the other. As in the
reference, a `None` leaf is structure, not data: it is not saved. A
bfloat16 leaf is saved as the bytes ml_dtypes' bfloat16 gives numpy (a
2-byte void item, `descr` `'<V2'`) and restored through an int16 view.
`save_lsm` / `restore_lsm` are host copies.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.failpoints import failpoint
from ..core.integrity import fsync_dir
from ..core.multihop import _resolve_device

__all__ = ["CheckpointManager", "save_lsm", "restore_lsm"]

# how ml_dtypes' bfloat16 names itself in an .npy header
_BF16_DESCR = "<V2"


def _flatten_with_paths(tree):
    """(key -> leaf for every non-None leaf, treespec): the reference's
    keys, in the pytree's own order."""
    flat, treedef = pytree.tree_flatten_with_path(tree)
    items = {}
    for path, leaf in flat:
        if leaf is not None:
            items["/".join(str(p) for p in path)] = leaf
    return items, treedef


def _host_copy(leaf):
    """A host snapshot of one leaf, taken before an async save returns:
    a CPU tensor, or a numpy array of anything else."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return None if leaf is None else np.array(leaf)


def _npy_array(leaf):
    """(numpy array, header descr or None) of one host leaf."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.contiguous().view(torch.int16).numpy(), _BF16_DESCR
        return leaf.contiguous().numpy(), None
    return np.asarray(leaf), None


def _savez(f, items) -> None:
    """`np.savez(f, **items)` with bfloat16 tensors written under
    ml_dtypes' descr: the same members, headers and bytes."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in items.items():
            arr, descr = _npy_array(leaf)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if descr is None:
                    np.lib.format.write_array(fid, arr, allow_pickle=True)
                    continue
                header = np.lib.format.header_data_from_array_1_0(arr)
                header["descr"] = descr
                np.lib.format.write_array_header_1_0(fid, header)
                fid.write(np.ascontiguousarray(arr).tobytes())


def _restore_leaf(raw: np.ndarray, tmpl, dev: torch.device):
    """A saved array as a tensor on `dev` with the template leaf's dtype
    (bfloat16 through an int16 view of its 2-byte items)."""
    if isinstance(tmpl, torch.Tensor) and tmpl.dtype == torch.bfloat16:
        if raw.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf was saved as {raw.dtype}")
        return torch.from_numpy(raw.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    if isinstance(tmpl, torch.Tensor):
        want = torch.empty(0, dtype=tmpl.dtype).numpy().dtype
    else:
        want = np.asarray(tmpl).dtype
    if raw.dtype != want:
        raw = raw.astype(want)
    return torch.from_numpy(np.array(raw)).to(dev)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- manifest helpers ------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "MANIFEST.json")

    def _read_manifest(self) -> Dict[str, Any]:
        p = self._manifest_path()
        if not os.path.exists(p):
            return {"checkpoints": []}
        with open(p) as f:
            return json.load(f)

    def _write_manifest(self, m: Dict[str, Any]) -> None:
        tmp = self._manifest_path() + ".tmp"
        failpoint("manifest.write")
        with open(tmp, "w") as f:
            json.dump(m, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        failpoint("manifest.rename")
        os.replace(tmp, self._manifest_path())      # atomic
        fsync_dir(self.dir)

    # -- save/restore ----------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = True) -> str:
        """Save a pytree snapshot for `step`."""
        host_tree = pytree.tree_map(_host_copy, tree)

        def _do():
            fname = f"step_{step:010d}.npz"
            fpath = os.path.join(self.dir, fname)
            items, _ = _flatten_with_paths(host_tree)
            tmp = fpath + ".tmp"
            with open(tmp, "wb") as f:       # file handle: no .npz suffixing
                _savez(f, items)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, fpath)           # atomic publish
            fsync_dir(self.dir)
            m = self._read_manifest()
            m["checkpoints"] = [c for c in m["checkpoints"] if c["step"] != step]
            m["checkpoints"].append({"step": step, "file": fname,
                                     "time": time.time()})
            m["checkpoints"].sort(key=lambda c: c["step"])
            while len(m["checkpoints"]) > self.keep:
                old = m["checkpoints"].pop(0)
                try:
                    os.remove(os.path.join(self.dir, old["file"]))
                except OSError:
                    pass
            self._write_manifest(m)

        if blocking:
            _do()
        else:
            self.wait()
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        return os.path.join(self.dir, f"step_{step:010d}.npz")

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest_step(self) -> Optional[int]:
        m = self._read_manifest()
        if not m["checkpoints"]:
            return None
        return m["checkpoints"][-1]["step"]

    def restore(self, template, step: Optional[int] = None, device=None):
        """Restore into the structure of `template`: every saved leaf a
        tensor on `device` (None: the GPU, raising when there is none) with
        its template leaf's dtype; `None` leaves stay `None`."""
        dev = _resolve_device(device, "checkpoint restore")
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints in " + self.dir)
        m = self._read_manifest()
        entry = next(c for c in m["checkpoints"] if c["step"] == step)
        flat, treedef = pytree.tree_flatten_with_path(template)
        leaves = []
        with np.load(os.path.join(self.dir, entry["file"])) as data:
            for path, tmpl in flat:
                leaves.append(None if tmpl is None else _restore_leaf(
                    data["/".join(str(p) for p in path)], tmpl, dev))
        return pytree.tree_unflatten(leaves, treedef), step


# ---------------------------------------------------------------------------
# Incremental LSM graph checkpoints (immutability → only new partitions hit disk)
# ---------------------------------------------------------------------------
def _partition_digest(part) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(part.src).tobytes())
    h.update(np.ascontiguousarray(part.dst).tobytes())
    return h.hexdigest()[:16]


def save_lsm(tree, directory: str) -> Dict[str, Any]:
    """Write LSM partitions not already present; returns the graph manifest.

    Partitions that already live in a content-addressed `PartitionStore`
    (a `GraphDB`'s disk tier) are HARD-LINKED into the checkpoint directory
    instead of re-serialized — the checkpoint is then a set of refs into
    the same immutable files, costing no data copy and surviving store GC
    (the inode lives until the last link drops). RAM partitions fall back
    to the npz path. Accepts a GraphDB or a bare LSMTree.

    Live buffers are captured too (`buffers.npz`, columns included) — the
    old checkpoints silently dropped unflushed edges, so a restore lost
    everything after the last flush. With buffers in the manifest the
    checkpoint is a complete recovery root on its own; the store's WAL
    segments are never referenced (restore needs no WAL replay)."""
    from ..core.disk import DiskPartition

    if hasattr(tree, "tree"):  # a GraphDB quacks like its tree
        tree = tree.tree
    os.makedirs(directory, exist_ok=True)
    manifest = {"levels": [], "intervals": {
        "n_partitions": tree.intervals.n_partitions,
        "interval_len": tree.intervals.interval_len,
    }, "written": 0, "reused": 0, "linked": 0,
        "column_dtypes": {k: np.dtype(dt).str
                          for k, dt in tree.column_dtypes.items()}}
    for li, level in enumerate(tree.levels):
        lvl = []
        for pi, part in enumerate(level):
            if isinstance(part, DiskPartition) and not part.dirty:
                fname = os.path.basename(part.path)
                fpath = os.path.join(directory, fname)
                if not os.path.exists(fpath):
                    failpoint("store.link")
                    try:
                        os.link(part.path, fpath)
                    except OSError:
                        shutil.copy2(part.path, fpath)
                    manifest["linked"] += 1
                else:
                    manifest["reused"] += 1
                entry = {"file": fname, "interval": list(part.interval),
                         "n_edges": part.n_edges, "format": "pal"}
                if part.dead is not None and part.dead.any():
                    dname = fname[:-4] + ".dead.npy"
                    with open(os.path.join(directory, dname), "wb") as df:
                        np.save(df, np.asarray(part.dead))
                    entry["dead_file"] = dname
                lvl.append(entry)
                continue
            digest = _partition_digest(part)
            fname = f"part_{digest}.npz"
            fpath = os.path.join(directory, fname)
            if not os.path.exists(fpath):
                cols = {f"col_{k}": np.asarray(v)
                        for k, v in part.columns.items()}
                np.savez(fpath, src=np.asarray(part.src),
                         dst=np.asarray(part.dst),
                         etype=np.asarray(part.etype),
                         dead=(part.dead if part.dead is not None
                               else np.zeros(0, bool)), **cols)
                manifest["written"] += 1
            else:
                manifest["reused"] += 1
            lvl.append({"file": fname, "interval": list(part.interval),
                        "n_edges": part.n_edges, "format": "npz"})
        manifest["levels"].append(lvl)
    # live (unflushed) buffers — staged internal-ID arrays, columns included
    if any(len(b) for b in getattr(tree, "buffers", [])):
        arrays = {}
        for j, b in enumerate(tree.buffers):
            if len(b) == 0:
                continue
            st = b.staging()
            arrays[f"b{j}_src"] = np.array(st.src)
            arrays[f"b{j}_dst"] = np.array(st.dst)
            arrays[f"b{j}_etype"] = np.array(st.etype)
            for k, v in st.columns.items():
                arrays[f"b{j}_col_{k}"] = np.array(v)
        tmp = os.path.join(directory, "buffers.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(directory, "buffers.npz"))
        manifest["buffers"] = "buffers.npz"
    tmp = os.path.join(directory, "GRAPH_MANIFEST.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, "GRAPH_MANIFEST.json"))
    fsync_dir(directory)
    return manifest


def restore_lsm(directory: str, column_dtypes=None, **lsm_kwargs):
    """Rebuild an LSMTree from a graph manifest (npz or linked .pal files),
    live buffers included — restore resumes with the exact unflushed edge
    set (and attribute values) the checkpoint captured."""
    from ..core.disk import open_partition_file
    from ..core.lsm import LSMTree
    from ..core.pal import IntervalMap, build_partition

    with open(os.path.join(directory, "GRAPH_MANIFEST.json")) as f:
        manifest = json.load(f)
    iv = IntervalMap(n_partitions=manifest["intervals"]["n_partitions"],
                     interval_len=manifest["intervals"]["interval_len"])
    n_levels = len(manifest["levels"])
    branching = 1
    if n_levels > 1:
        branching = len(manifest["levels"][1]) // len(manifest["levels"][0])
    if column_dtypes is None:
        column_dtypes = {k: np.dtype(s)
                         for k, s in manifest.get("column_dtypes", {}).items()}
    tree = LSMTree(iv, n_levels=n_levels, branching=max(branching, 1),
                   column_dtypes=column_dtypes or {}, **lsm_kwargs)
    for li, lvl in enumerate(manifest["levels"]):
        for pi, entry in enumerate(lvl):
            fpath = os.path.join(directory, entry["file"])
            if entry.get("format", "npz") == "pal":
                part = open_partition_file(fpath)
                if entry.get("dead_file"):
                    part.dead = np.load(
                        os.path.join(directory, entry["dead_file"]))
                tree.levels[li][pi] = part
                continue
            data = np.load(fpath)
            cols = {k[4:]: data[k] for k in data.files if k.startswith("col_")}
            part = build_partition(tuple(entry["interval"]), data["src"],
                                   data["dst"], data["etype"], cols,
                                   presorted=True)
            if data["dead"].size:
                part.dead = data["dead"]
            tree.levels[li][pi] = part
    if manifest.get("buffers"):
        data = np.load(os.path.join(directory, manifest["buffers"]))
        for j in range(len(tree.buffers)):
            if f"b{j}_src" not in data.files:
                continue
            cols = {k[len(f"b{j}_col_"):]: data[k] for k in data.files
                    if k.startswith(f"b{j}_col_")}
            # buffer arrays are staged INTERNAL ids: restore them directly
            # (insert_edges would re-hash and re-route)
            tree.buffers[j].extend(data[f"b{j}_src"], data[f"b{j}_dst"],
                                   data[f"b{j}_etype"], cols)
            tree._buffered += int(data[f"b{j}_src"].shape[0])
    return tree
