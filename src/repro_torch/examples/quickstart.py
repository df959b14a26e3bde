"""Quickstart of the port: train the llama smoke model briefly, then serve
the trained weights (the counterpart of the repository's
``examples/quickstart.py``)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

On the card unless ``--device`` says otherwise (no card is an error).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..configs import get_smoke
from ..inference.engine import InferenceEngine
from ..launch.train import run_training
from ..models.transformer import make_plan


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, an error without a "
                        "card)")
    p.add_argument("--steps", type=int, default=40)
    args = p.parse_args(argv)
    # 1) train a smoke-scale llama on the synthetic Markov LM task
    out = run_training("llama3.2-1b", steps=args.steps, global_batch=8,
                       seq_len=32, microbatches=2, base_lr=1e-2,
                       log_every=10, device=args.device)
    losses = [h["loss"] for h in out["history"]]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], losses

    # 2) serve the trained weights
    cfg = get_smoke("llama3.2-1b")
    eng = InferenceEngine(make_plan(cfg, 1), out["model"], s_max=96,
                          device=args.device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    res = eng.generate(prompts, 16)
    print(f"generated {res.new_tokens.shape} tokens on {eng.device}, "
          f"{res.decode_tokens_per_s:.0f} tok/s decode")
    print("sample:", res.new_tokens[0][:10].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
