"""End-to-end trainer (port of the reference `repro/launch/train.py`): any
LM --arch, checkpoint/restart fault tolerance.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --smoke --steps 200 --ckpt-dir ckpt [--resume]      # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 3                                  # on the CPU, plain versions

--smoke trains the arch's reduced config; without it the full config is
used. The loop, as the reference's: deterministic restart-safe data
(`TokenStream.batch_at(step)`), AdamW with `linear_warmup_cosine`, async
checkpoints of {"params", "opt"} every --ckpt-every steps (the reference's
keys, so either package resumes the other's), auto-resume from the newest
manifest with --resume, and the same step-time log line. Weights are drawn
on the device from --seed (a torch generator gives other numbers than the
reference's jax key 0). The step time ends in a device synchronize.

`train_step` is one step: the loss and its gradient by autograd, then
`adamw_update`, which updates params and optimizer state in place."""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..checkpoint import CheckpointManager
from ..configs import get_arch
from ..core.multihop import _resolve_device
from ..data import TokenStream, TokenStreamConfig
from ..models import transformer
from ..optim import AdamWConfig, adamw_init, adamw_update, linear_warmup_cosine

__all__ = ["main", "train_step"]


def train_step(params, opt, batch, cfg, opt_cfg: AdamWConfig,
               sched: Optional[Callable] = None,
               loss_fn: Callable = transformer.loss_fn):
    """One step: (params, opt, loss, metrics) after `loss_fn(params, batch,
    cfg)` (default: the transformer's), its gradient and an AdamW update
    with `sched`. params and opt are updated in place; loss and the
    metrics stay on the device."""
    leaves, spec = pytree.tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = loss_fn(pytree.tree_unflatten(live, spec), batch, cfg)
    grads = torch.autograd.grad(loss, live)
    del live
    params, opt, metrics = adamw_update(
        pytree.tree_unflatten(list(grads), spec), opt, params, opt_cfg,
        schedule=sched)
    return params, opt, loss.detach(), metrics


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit("train.py drives LM archs")
    cfg = spec.smoke_config if args.smoke else spec.config
    dev = _resolve_device(args.device, "training")

    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq))
    opt_cfg = AdamWConfig(lr=args.lr)
    sched = linear_warmup_cosine(min(20, args.steps // 10 + 1), args.steps)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = transformer.init_params(cfg, gen, dev)
    opt = adamw_init(params)
    start_step = 0

    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    if args.resume and mgr.latest_step() is not None:
        restored, start_step = mgr.restore({"params": params, "opt": opt},
                                           device=dev)
        params, opt = restored["params"], restored["opt"]
        print(f"resumed from step {start_step}")

    step_times, loss = [], None
    try:
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in stream.batch_at(step).items()}
            params, opt, loss, metrics = train_step(params, opt, batch, cfg,
                                                    opt_cfg, sched)
            _sync(dev)
            dt = time.time() - t0
            step_times.append(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                med = float(np.median(step_times[-50:]))
                straggle = dt / max(med, 1e-9)
                print(f"step {step:5d} loss {float(loss):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"dt {dt*1e3:.0f}ms (x{straggle:.1f} of median)")
            if (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt},
                         blocking=False)
        mgr.save(args.steps, {"params": params, "opt": opt})
    finally:
        mgr.wait()          # a save in flight lands before the run ends
    if loss is not None:
        print(f"done; final loss {float(loss):.4f}; "
              f"median step {np.median(step_times)*1e3:.0f}ms")


if __name__ == "__main__":
    main()
