"""PyTorch + CUDA port of the GraphChi-DB reproduction in `repro`.

It mirrors `repro` module for module and imports neither `jax` nor `repro`.
Host-side store modules are numpy copies; work that moves to the GPU is
torch, and each Pallas TPU kernel of the reference becomes a hand-written
Hopper kernel under `kernels/`."""
