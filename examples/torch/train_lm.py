"""End-to-end LM training on the PyTorch port: trains the reduced
granite config for a few hundred steps with checkpoints + resume.

  PYTHONPATH=src python examples/torch/train_lm.py [--device cpu]
(equivalent to: python -m repro_torch.launch.train --arch granite-3-2b
 --smoke; checkpoints go under the temp directory)
"""
import argparse
import os
import subprocess
import sys
import tempfile

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--steps", type=int, default=120)
args = ap.parse_args()

root = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
subprocess.run([
    sys.executable, "-m", "repro_torch.launch.train",
    "--arch", "granite-3-2b", "--smoke",
    "--steps", str(args.steps), "--batch", "8", "--seq", "64",
    "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                               "repro_torch_example_ckpt"),
    "--ckpt-every", "40", "--device", args.device,
], check=True, env={**os.environ, "PYTHONPATH": os.path.join(root, "src")})
