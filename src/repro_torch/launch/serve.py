"""Batched decode server (port of the reference `repro/launch/serve.py`):
batches of requests, each a prefill and then a greedy decode loop.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --requests 8 --gen 16                     # the smoke config, on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
      --prompt-len 4096 --gen 32                # the full config

The reference's `--smoke` is `store_true` with `default=True`, so its full
config cannot be reached from the command line (ROADMAP queue 3 note d);
here `--no-smoke` reaches it. Weights are random, drawn on the device from
seed 0; prompts are drawn with numpy from seed 0, as the reference does."""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..configs import get_arch
from ..core.multihop import _resolve_device
from ..models import transformer

__all__ = ["main", "serve_requests"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_requests(params, cfg, prompts, batch: int, gen: int, device=None
                   ) -> Tuple[np.ndarray, List[Dict[str, float]]]:
    """Serve `prompts` (R, P) token ids `batch` requests at a time: a
    prefill, then `gen - 1` greedy decode steps (argmax over the padded
    vocab, as the reference takes it) over a bf16 KV cache. The params are
    cast to the compute dtype once, before the first batch
    (`transformer.cast_params`).

    Returns (tokens (R, gen) int64, one dict per batch: requests,
    prefill_s, decode_s and latency_s on the host clock, each ending in a
    device synchronize). `device` defaults to the GPU."""
    dev = _resolve_device(device, "serving")
    prompts = np.asarray(prompts)
    if prompts.ndim != 2 or gen < 1 or batch < 1:
        raise ValueError(f"expected prompts (R, P), gen >= 1, batch >= 1; "
                         f"got {prompts.shape}, {gen}, {batch}")
    R, P = prompts.shape
    params = transformer.cast_params(params, cfg)
    tokens, stats = [], []
    with torch.no_grad():
        for i in range(0, R, batch):
            toks = torch.from_numpy(prompts[i:i + batch].astype(np.int64)
                                    ).to(dev)
            t0 = time.perf_counter()
            logits, cache = transformer.prefill(params, toks, cfg,
                                                max_seq=P + gen)
            out = [logits.argmax(-1)]
            _sync(dev)
            t1 = time.perf_counter()
            for j in range(gen - 1):
                logits, cache = transformer.decode_step(
                    params, cache, out[-1][:, None], P + j, cfg)
                out.append(logits.argmax(-1))
            _sync(dev)
            t2 = time.perf_counter()
            tokens.append(torch.stack(out, 1).cpu().numpy())
            stats.append({"requests": int(toks.shape[0]), "prefill_s": t1 - t0,
                          "decode_s": t2 - t1, "latency_s": t2 - t0})
            del cache
    return np.concatenate(tokens), stats


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args()

    spec = get_arch(args.arch)
    cfg = spec.smoke_config if args.smoke else spec.config
    dev = _resolve_device(args.device, "serving")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size,
                           (args.requests, args.prompt_len))
    _, stats = serve_requests(params, cfg, prompts, args.batch, args.gen, dev)
    done = 0
    for s in stats:
        done += s["requests"]
        dt = s["latency_s"]
        print(f"batch of {s['requests']}: {dt*1e3:.0f}ms "
              f"({s['requests'] * args.gen / dt:.1f} tok/s; prefill "
              f"{s['prefill_s']*1e3:.0f}ms); total served {done}")
    print(f"served {done} requests on {dev}; median batch latency "
          f"{np.median([s['latency_s'] for s in stats])*1e3:.0f}ms")


if __name__ == "__main__":
    main()
