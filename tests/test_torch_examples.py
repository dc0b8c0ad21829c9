"""The port's examples (examples/torch/) run on the CPU: the quickstart
end to end, and the distributed example on four gloo ranks, whose PSW
PageRank over the ranks is bitwise the one-device one."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(script, *argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, os.path.join(
        ROOT, "examples", "torch", script), *argv], capture_output=True,
        text=True, env=env, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_quickstart_on_the_cpu():
    out = run("quickstart.py", "--device", "cpu")
    assert "device pagerank on cpu" in out and out.rstrip().endswith("done.")


def test_distributed_gnn_on_four_gloo_ranks():
    out = run("distributed_gnn.py", "--device", "cpu")
    assert "dense_gather: 4 ranks, bitwise one-device: True" in out
    assert "psw_windows: 4 ranks, bitwise one-device: True" in out
    assert "max diff: 0.00e+00" in out
