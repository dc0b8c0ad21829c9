"""The port's crash harness (repro_torch/torture.py) against the
reference's (repro/torture.py), on the CPU: a few of tests/test_torture.py's
crash schedules run through `python -m repro_torch.torture` in a
subprocess that dies at a failpoint, then recovery is verified; the
reference's `verify` checks a directory the port crashed, and the port's
a directory the reference crashed (the store files are the same)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro import torture as rtorture
from repro_torch import torture as ttorture
from repro_torch.core import CRASH_EXIT_CODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
BATCHES, BATCH_SIZE = 8, 120


def run_torture(package, cmd, dbdir, oracle, failpoints=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("GRAPHDB_FAILPOINTS", None)
    if failpoints:
        env["GRAPHDB_FAILPOINTS"] = failpoints
    return subprocess.run(
        [sys.executable, "-m", f"{package}.torture", cmd, dbdir,
         "--oracle", oracle, "--batches", str(BATCHES),
         "--batch-size", str(BATCH_SIZE)],
        env=env, capture_output=True, text=True, timeout=300)


def test_the_op_stream_is_the_references():
    assert CRASH_EXIT_CODE == 41
    assert ttorture.total_ops(BATCHES) == rtorture.total_ops(BATCHES)
    for i in range(BATCHES):
        for a, b in zip(ttorture.gen_batch(i, BATCH_SIZE, 7, 999),
                        rtorture.gen_batch(i, BATCH_SIZE, 7, 999)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for (ka, (sa, da)), (kb, (sb, db)) in zip(
            ttorture.reference_states(BATCHES, BATCH_SIZE, 7),
            rtorture.reference_states(BATCHES, BATCH_SIZE, 7)):
        assert ka == kb
        assert np.array_equal(sa, sb) and np.array_equal(da, db)


@pytest.mark.parametrize("spec", ["wal.append.write=crash@5",
                                  "part.write.rename=crash@1",
                                  "service.ckpt.phaseB=crash"])
def test_crash_point_recovers_to_durable_prefix(tmp_path, spec):
    dbdir, oracle = str(tmp_path / "db"), str(tmp_path / "oracle.log")
    run = run_torture("repro_torch", "run", dbdir, oracle, failpoints=spec)
    assert run.returncode in (0, CRASH_EXIT_CODE), (
        f"{spec}: rc={run.returncode}\n{run.stdout}\n{run.stderr}")
    ver = run_torture("repro_torch", "verify", dbdir, oracle)
    assert ver.returncode == 0, f"{spec}:\n{ver.stdout}\n{ver.stderr}"


@pytest.mark.parametrize("crashed_by,verifier", [("repro_torch", rtorture),
                                                 ("repro", ttorture)])
def test_each_package_verifies_the_others_crash(tmp_path, crashed_by,
                                                verifier):
    dbdir, oracle = str(tmp_path / "db"), str(tmp_path / "oracle.log")
    run = run_torture(crashed_by, "run", dbdir, oracle,
                      failpoints="wal.append.write=crash@9")
    assert run.returncode == CRASH_EXIT_CODE, run.stderr
    res = verifier.verify_recovery(dbdir, oracle, batches=BATCHES,
                                   batch_size=BATCH_SIZE)
    assert res["ok"] and res["recovered_prefix"] >= res["acked"] > 0


def test_clean_run_recovers_everything(tmp_path):
    dbdir, oracle = str(tmp_path / "db"), str(tmp_path / "oracle.log")
    assert run_torture("repro_torch", "run", dbdir, oracle).returncode == 0
    res = ttorture.verify_recovery(dbdir, oracle, batches=BATCHES,
                                   batch_size=BATCH_SIZE)
    assert res["recovered_prefix"] == res["acked"] == ttorture.total_ops(
        BATCHES)
