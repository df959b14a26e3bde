"""Training entry point of the port (the port of ``repro/launch/train.py``):
the dense family at tp=1, or data-parallel over the pods of a virtual
mesh on the one device::

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 50
    python -m repro_torch.launch.train --arch llama3.2-1b --device cpu \
        --pods 4 --grad-reduce rd --ckpt-dir /tmp/ck
    python -m repro_torch.launch.train --arch llama3.2-1b --full \
        --layers 4 --seq-len 1024 --global-batch 8

The run is on the card unless ``--device`` says otherwise (no card is an
error).  The weights are the port's seeded init, the data the seeded
synthetic Markov LM (``training/data.py``); nothing is downloaded.

Fault tolerance, as in the reference:
  * resume from the latest checkpoint on start (``--ckpt-dir``); async,
    atomic, mesh-agnostic checkpoints every ``--ckpt-every`` steps
  * SIGTERM / SIGINT preemption: the step in flight finishes, a
    synchronous checkpoint is written, and the run returns with
    ``preempted: True``
  * NaN / Inf gradient skipping (inside the step, on the device)
  * straggler watchdog: a per-step wall-clock EMA; a step slower than
    ``--straggler-factor`` x the EMA is logged
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time
from typing import Optional

from ..configs import ARCH_IDS, get_config, get_smoke
from ..core.mesh import VirtualMesh
from ..core.pcontext import ParallelCtx, single_pod_ctx
from ..inference.engine import resolve_device
from ..models.transformer import (data_parallel, init_params, make_plan,
                                  params_tree, trainable)
from ..parallel.steps import build_train_step, load_train_state, train_state
from ..training import checkpoint as ckpt
from ..training.data import SyntheticLMData
from ..training.optimizer import adamw_init


def run_training(arch: str, *, steps: int = 50, smoke: bool = True,
                 seq_len: int = 64, global_batch: int = 8,
                 microbatches: int = 2, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 25, base_lr: float = 1e-2,
                 pods: int = 1,
                 grad_reduce: str = "rd", straggler_factor: float = 3.0,
                 log_every: int = 10, seed: int = 0, remat: bool = True,
                 layers: Optional[int] = None,
                 device: Optional[str] = None) -> dict:
    """Train ``arch`` (its smoke config, or ``smoke=False`` its full one,
    ``layers`` deep if given) for ``steps`` steps.
    ``pods`` > 1: data-parallel over a ``VirtualMesh(pods, 1)`` (ctx dp =
    ("pod",), ``grad_reduce`` the cross-pod sum); else one rank under the
    reference's training ctx.  Returns {"history": one dict a step
    (step, loss, grad_norm, skipped, wall_s), "model" (frozen again),
    "opt", "preempted", "stopped_at"}."""
    cfg = get_smoke(arch) if smoke else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = resolve_device(device)
    ap = make_plan(cfg, 1)
    mesh = VirtualMesh(pods, 1, device=dev) if pods > 1 else None
    ctx = ParallelCtx(dp=("pod",), grad_reduce_strategy=grad_reduce) \
        if pods > 1 else single_pod_ctx(grad_reduce_strategy=grad_reduce)
    step_fn = build_train_step(ap, ctx, mesh, microbatches=microbatches,
                               remat=remat, base_lr=base_lr, warmup=5,
                               total_steps=steps)
    model = init_params(ap, seed=seed, device=dev)
    if pods > 1:
        model = data_parallel(model, pods)
    opt = adamw_init(params_tree(model))
    start_step = 0
    saver = None
    if ckpt_dir:
        saver = ckpt.AsyncCheckpointer(ckpt_dir)
        if ckpt.latest_step(ckpt_dir) is not None:
            start_step, state = ckpt.restore(ckpt_dir,
                                             train_state(model, opt))
            load_train_state(model, opt, state)
            print(f"[train] resumed from step {start_step}")

    data = SyntheticLMData(cfg.vocab_size, seq_len, global_batch, seed=seed)
    preempted = {"flag": False}

    def on_signal(signum, frame):
        preempted["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        old_handlers[sig] = signal.signal(sig, on_signal)

    history = []
    ema = None
    try:
        for step in range(start_step, steps):
            batch = data.batch(step)
            t0 = time.perf_counter()
            model, opt, metrics = step_fn(model, opt, batch)
            loss = float(metrics["loss"])        # waits for the device
            dt = time.perf_counter() - t0
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > straggler_factor * ema and step > start_step + 3:
                print(f"[train] straggler: step {step} took {dt:.2f}s "
                      f"(ema {ema:.2f}s)")
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "skipped": float(metrics["skipped"]),
                            "wall_s": dt})
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
            if saver and (step + 1) % ckpt_every == 0:
                saver.save(step + 1, train_state(model, opt))
            if preempted["flag"]:
                print("[train] preemption signal: checkpointing + exit")
                if saver:
                    saver.wait()
                if ckpt_dir:
                    ckpt.save(ckpt_dir, step + 1, train_state(model, opt))
                return {"history": history, "model": trainable(model, False),
                        "opt": opt, "preempted": True, "stopped_at": step + 1}
        if saver:
            saver.save(steps, train_state(model, opt))
            saver.wait()
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
    return {"history": history, "model": trainable(model, False), "opt": opt,
            "preempted": False, "stopped_at": steps}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--smoke", action="store_true", default=True)
    p.add_argument("--full", dest="smoke", action="store_false")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth (full width kept)")
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--microbatches", type=int, default=2)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--grad-reduce", default="rd",
                   choices=["flat", "rd", "rd_int8"])
    p.add_argument("--pods", type=int, default=1,
                   help="data-parallel replicas on the virtual mesh's slow "
                        "axis")
    p.add_argument("--no-remat", dest="remat", action="store_false")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, an error without a "
                        "card)")
    args = p.parse_args(argv)
    out = run_training(args.arch, steps=args.steps, smoke=args.smoke,
                       seq_len=args.seq_len, global_batch=args.global_batch,
                       microbatches=args.microbatches,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       base_lr=args.lr, grad_reduce=args.grad_reduce,
                       pods=args.pods, remat=args.remat, layers=args.layers,
                       seed=args.seed, device=args.device)
    print(f"[train] done: final loss "
          f"{out['history'][-1]['loss']:.4f}, preempted={out['preempted']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
