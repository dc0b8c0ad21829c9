"""Production mesh construction (port of the reference `repro/launch/mesh.py`).

A FUNCTION (not a module-level constant) so importing this module never
touches device or process-group state. The shapes and axis names are the
reference's, so the sharding rules shard every tensor as they do there:
(16, 16) as ("data", "model"), (2, 16, 16) as ("pod", "data", "model").
On H100 nodes of 8 GPUs a 16-wide `model` axis spans two NVLink domains.

`init_device_mesh` needs an initialised default process group of the
mesh's size (256 or 512 ranks); the dry-run gives it a `fake` one.
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "H100_SXM"]

# NVIDIA H100 SXM5 80GB, per GPU, from NVIDIA's H100 Tensor Core GPU
# datasheet: dense (not sparse) bf16 tensor-core peak, HBM3 bandwidth,
# NVLink 4 at 900 GB/s total (450 GB/s each direction), 80 GB of HBM,
# 228 KiB of shared memory per SM, 132 SMs.
H100_SXM = {
    "peak_flops_bf16": 989e12,    # FLOP/s
    "hbm_bytes_per_s": 3.35e12,   # HBM bandwidth
    "nvlink_bytes_per_s": 450e9,  # per direction
    "hbm_bytes": 80e9,
    "smem_bytes_per_sm": 228 * 2**10,
    "n_sms": 132,
}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
