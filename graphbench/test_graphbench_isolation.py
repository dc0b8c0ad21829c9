"""The JAX check by whole top-level names, and what the harness's files
import."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

from graphbench.isolation import forbidden_loaded
from graphbench.registry import HERE, ROOT


def test_whole_top_level_names():
    assert forbidden_loaded(["repro_torch", "repro_torch.core",
                             "reprocess", "jaxtyping", "numpy"]) == []
    assert forbidden_loaded(["repro.core.pal", "jax.numpy", "jaxlib",
                             "flax.linen", "torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path


def test_reference_and_generator_import_nothing_of_the_program():
    for sub in ("reference", "gen"):
        for path in (HERE / sub).rglob("*.py"):
            assert "repro_torch" not in _imports(path), path
            assert "benchmarks" not in _imports(path), path


def test_no_file_reads_the_old_records():
    for path in HERE.rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        for old in ("chip_smoke", "experiments/", "benchmarks."):
            assert old not in text, (path, old)


def test_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and graphbench/, a
    run exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "graphbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "graphbench/run.py", "--workload", "lj.fof",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "correct" not in p.stdout
