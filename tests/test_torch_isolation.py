"""The port stands alone: every `repro_torch` module imports with `jax` and
`repro` blocked, the dense path refuses to drop silently to the CPU, and
`chip_smoke.py` fails, printing no result, where there is no GPU or no
checkout around it."""
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.core as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def test_every_module_imports_without_jax_or_repro():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    for name in ("kernels.frontier_expand.kernel", "kernels.common",
                 "kernels.segment_ell.kernel", "kernels.segment_ell.ops",
                 "kernels.segment_ell.ref", "kernels.psw_spmm.kernel",
                 "kernels.psw_spmm.ops", "kernels.psw_spmm.ref",
                 "graph.padding", "core.psw", "convert",
                 "kernels.flash_attention.kernel",
                 "kernels.flash_attention.ops", "kernels.flash_attention.ref",
                 "kernels.embedding_bag.kernel", "kernels.embedding_bag.ops",
                 "kernels.embedding_bag.ref", "models.transformer",
                 "configs.granite_3_2b", "configs.granite_34b",
                 "configs.qwen3_14b", "launch.serve", "core.failpoints",
                 "core.integrity", "core.codec", "core.walog", "core.disk",
                 "checkpoint", "checkpoint.manager", "core.deadline",
                 "core.service", "core.frontdesk", "core.shardrouter",
                 "torture", "data", "data.linkbench", "data.pipeline"):
        assert "repro_torch." + name in mods, name
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok', len(" + repr(mods) + "))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_a_spawned_shard_worker_loads_neither_jax_nor_repro(tmp_path):
    """A port shard worker is a spawned interpreter running
    `repro_torch.core.shardrouter._worker_main`: it imports the port and
    torch, never jax or the reference, and creates no CUDA context."""
    with T.ShardRouter.create(str(tmp_path / "rt"), max_id=999, n_shards=2,
                              n_partitions=4, n_levels=2,
                              branching=2) as router:
        runtime = router.worker_runtime()
    assert len({rt["pid"] for rt in runtime}) == 2
    for rt in runtime:
        assert rt["pid"] != os.getpid()
        assert rt["modules"] == ["torch"], rt
        assert rt["cuda_initialized"] is False


def test_dense_path_without_a_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means it")
    g = T.GraphPAL.from_edges(np.arange(10), np.arange(1, 11), n_partitions=2,
                              max_id=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.dense_plan(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.two_hop_counts(g, [0, 1], dense="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.khop(g, [0], 2, dense="kernel")
    # the auto heuristic never reaches for the absent device
    assert T.bfs(g, 0, 3) == {0: 0, 1: 1, 2: 2, 3: 3}


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_checkout(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, cwd=cwd, env=env, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
