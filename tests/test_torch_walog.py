"""The port's segmented WAL (repro_torch/core/walog.py) against the
reference's (repro/core/walog.py), on the CPU. One seeded sequence of
inserts with columns, deletes, column writes, rotations and compactions
must give byte-identical segment files in both packages; each package must
replay the other's directory to the same records; and a torn tail must be
dropped and truncated the same way. Every comparison is exact."""
import os
import shutil

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.core import walog as R
from repro_torch.core import walog as T

COLUMNS = {"w": np.float32, "t": np.int32}


def drive(mod, path, seed: int, n_ops: int = 60, segment_bytes: int = 512,
          compact_every: int = 25, close: bool = True):
    """One seeded mutation sequence through `mod.SegmentedWAL`."""
    rng = np.random.default_rng(seed)
    w = mod.SegmentedWAL(path, column_dtypes=COLUMNS,
                         segment_bytes=segment_bytes)
    marks = []
    for i in range(n_ops):
        kind = rng.integers(0, 4)
        if kind <= 1:
            m = int(rng.integers(0, 9))
            cols = {"w": rng.random(m).astype(np.float32)}
            if kind == 1:            # the other column logs as zeros
                cols["t"] = rng.integers(-5, 5, m).astype(np.int32)
            w.append_inserts(rng.integers(0, 1 << 40, m),
                             rng.integers(0, 1 << 40, m),
                             rng.integers(0, 3, m).astype(np.int8), cols)
        elif kind == 2:
            w.append_delete(int(rng.integers(0, 1 << 40)),
                            int(rng.integers(0, 1 << 40)))
        else:
            name = "w" if rng.random() < 0.5 else "t"
            w.append_column(name, int(rng.integers(0, 1000)),
                            int(rng.integers(0, 1000)),
                            rng.random() * 100)
        marks.append(w.tail_offset())
        if compact_every and (i + 1) % compact_every == 0:
            w.compact(marks[len(marks) // 2])
    if close:
        w.close()
    return w


def tree_bytes(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


def records(ops):
    """Replayed records as comparable tuples (arrays by dtype and bytes)."""
    def norm(v):
        if isinstance(v, dict):
            return tuple((k, norm(v[k])) for k in sorted(v))
        if isinstance(v, (np.ndarray, np.generic)):
            a = np.asarray(v)
            return (a.dtype.str, a.shape, a.tobytes())
        return v
    return [tuple(norm(x) for x in op) for op in ops]


@pytest.mark.parametrize("seed,segment_bytes,compact_every",
                         [(0, 512, 25), (1, 256, 10), (2, 1 << 20, 0),
                          (3, 200, 7)])
def test_segment_files_byte_identical(tmp_path, seed, segment_bytes,
                                      compact_every):
    r = drive(R, str(tmp_path / "ref"), seed, segment_bytes=segment_bytes,
              compact_every=compact_every)
    t = drive(T, str(tmp_path / "port"), seed, segment_bytes=segment_bytes,
              compact_every=compact_every)
    want = tree_bytes(str(tmp_path / "ref"))
    assert tree_bytes(str(tmp_path / "port")) == want
    if segment_bytes < 1 << 20:
        assert len(want) > 1, "no rotation happened"
    assert [s[:2] for s in r.segments()] == [s[:2] for s in t.segments()]
    assert r.tail_offset() == t.tail_offset()
    assert r.on_disk_bytes() == t.on_disk_bytes()


@pytest.mark.parametrize("writer,reader", [(R, T), (T, R)])
def test_each_package_replays_the_others_directory(tmp_path, writer, reader):
    path = str(tmp_path / "wal")
    w = drive(writer, path, seed=4, compact_every=0)
    mid = w.segments()[1][0]
    end = w.tail_offset()
    ro = reader.SegmentedWAL(path, readonly=True)
    assert ro.tail_offset() == end
    for offset, stop in ((0, None), (mid, None), (0, mid)):
        assert records(ro.replay(offset=offset, end=stop)) == records(
            writer.SegmentedWAL(path, readonly=True).replay(offset=offset,
                                                            end=stop))
    # a writer of the other package appends where this one stopped
    rw = reader.SegmentedWAL(path, column_dtypes=COLUMNS, segment_bytes=512)
    rw.append_delete(7, 8)
    rw.close()
    assert records(writer.SegmentedWAL(path, readonly=True).replay())[-1] \
        == ("delete", 7, 8)


@pytest.mark.parametrize("torn", [b"\x01\x05\x00", b"\x02" + bytes(9),
                                  b"\x03\x00"])
def test_torn_tail_dropped_and_truncated_alike(tmp_path, torn):
    base = str(tmp_path / "base")
    drive(R, base, seed=5, n_ops=20, compact_every=0)
    seg = sorted(os.listdir(base))[-1]
    with open(os.path.join(base, seg), "ab") as f:
        f.write(torn)
    out = {}
    for name, mod in (("ref", R), ("port", T)):
        path = str(tmp_path / name)
        shutil.copytree(base, path)
        n = len(list(mod.SegmentedWAL(path, readonly=True).replay()))
        w = mod.SegmentedWAL(path, column_dtypes=COLUMNS, segment_bytes=512)
        w.append_delete(9, 9)
        w.close()
        out[name] = (n, w.tail_offset(), tree_bytes(path))
    assert out["port"] == out["ref"]


@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 40))
@settings(max_examples=10, deadline=None)
def test_property_same_bytes_and_records(seed, n_ops):
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        r = drive(R, os.path.join(d, "r"), seed, n_ops=n_ops, segment_bytes=300,
                  compact_every=9)
        t = drive(T, os.path.join(d, "t"), seed, n_ops=n_ops, segment_bytes=300,
                  compact_every=9)
        assert tree_bytes(os.path.join(d, "t")) == tree_bytes(
            os.path.join(d, "r"))
        assert records(t.replay()) == records(r.replay())
