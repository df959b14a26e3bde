"""Serving entry point of the port: batched generation and trace replay (the
counterparts of ``repro.launch.serve --mode batch`` and ``--mode trace``).

    python -m repro_torch.launch.serve --arch llama3.2-1b --mode batch --full
    python -m repro_torch.launch.serve --arch llama3.2-1b --mode batch \
        --block-size 16 --device cpu        # smoke config on the CPU
    python -m repro_torch.launch.serve --arch llama3.2-1b --mode batch \
        --full --tp 8 --pods 4 --ar-strategy hier_rd   # TP on one card
    python -m repro_torch.launch.serve --arch llama3.2-1b --mode batch \
        --full --tp 8 --pods 4 --ar-strategy auto --overlap   # the paper's
    python -m repro_torch.launch.serve --arch llama3.2-1b --mode batch \
        --full --tp 8 --pods 4 --ar-strategy hier_rd --ar-quant int8
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --full \
        --batch 8 --prompt-len 128 --block-size 16        # MoE on one card
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --full \
        --layers 4 --tp 8 --pods 4 --ar-strategy hier_rd  # MoE, TP x EP
    python -m repro_torch.launch.serve --arch rwkv6-7b --full \
        --batch 8 --prompt-len 512 --max-new 64           # RWKV6 on one card
    python -m repro_torch.launch.serve --arch rwkv6-7b --full \
        --tp 8 --pods 4 --ar-strategy hier_rd             # RWKV6, TP
    python -m repro_torch.launch.serve --arch hymba-1.5b --full \
        --batch 8 --prompt-len 1280 --max-new 64 --block-size 16  # hybrid
    python -m repro_torch.launch.serve --arch hymba-1.5b --full \
        --tp 8 --pods 4 --ar-strategy hier_rd             # hybrid, TP
    python -m repro_torch.launch.serve --arch hymba-1.5b --device cpu \
        --block-size 16                   # hybrid smoke config on the CPU
    python -m repro_torch.launch.serve --mode trace --device cpu \
        --block-size 8                    # continuous batching, smoke
    python -m repro_torch.launch.serve --arch llama3.2-1b --mode trace \
        --full --slots 8 --s-max 1024 --n-requests 32 --mean-in 256 \
        --mean-out 64 --rate 0.5 --block-size 16 [--tp 8 --pods 4 \
        --ar-strategy hier_rd]            # continuous batching on the card
    python -m repro_torch.launch.serve --mode trace --device cpu \
        --block-size 8 --admit-mode chunked --admit-chunk 16 \
        [--prefix-cache on --shared-frac 0.75 --prefix-len 32] \
        [--spec-mode ngram --spec-k 4]    # chunked, prefix cache, spec

Weights come from the port's seeded initialiser (``--seed``); nothing is
downloaded.  The run is on the card unless ``--device`` says otherwise.
``--tp > 1`` runs the tensor-parallel path over a virtual mesh of
``--pods`` x ``tp/pods`` ranks on that one device; ``--ar-strategy auto``
picks the all-reduce per call from the autotune table (``--ar-table``,
else the analytic model), and ``--overlap`` overlaps the row-parallel
projections with their all-reduces (under ``hier_rd`` in the fused GEMM +
recursive-doubling kernel).  ``--ar-quant int8|int4`` puts the all-reduces
on the quantized wire (packed payloads with per-group scales on every
phase, error feedback on the decode residuals); ``auto`` picks the level
per call and needs ``--ar-strategy auto``.  A MoE arch (``--arch
qwen3-moe-30b-a3b``, ``dbrx-132b`` for the smoke config only) runs its
experts through the grouped expert FFN kernel, parallel over the TP ranks
(the prompt length must then divide by ``--tp``).  The ssm arch
``rwkv6-7b`` runs every time-mix recurrence, prefill and decode, through
the RWKV6 scan kernel; its cache is the recurrent state, with no K/V to
page, so ``--block-size`` > 0 raises.  The hybrid arch ``hymba-1.5b``
runs attention (windowed, through the attention kernels) and a Mamba
mixer side by side in every block, every selective-scan recurrence,
prefill and decode, through the selective-scan kernel; its cache is the
K/V (paged under ``--block-size``) beside the mamba state.  ``--layers
N`` cuts the config's depth to N layers (widths kept), and the
``[serve]`` line then shows the depth.

``--mode trace`` replays a BurstGPT-style trace (``make_trace``:
``--n-requests`` requests, lognormal prompt and output lengths around
``--mean-in`` / ``--mean-out``, gamma arrivals at ``--rate`` a step)
through the continuous batcher: ``--slots`` slots of ``--s-max``
positions, full-prefill admission, dense or paged (``--block-size``, a
pool of ``--n-blocks`` a rank) with preemption when the pool runs dry,
greedy or sampled (``--temperature``, ``--top-k``, each request's own
chain under ``--seed``), at tp=1 or on the virtual mesh; it prints
throughput, TTFT and TPOT and writes the metrics to ``--json-out``.  On
the card the decode steps of both modes replay a CUDA graph.
``--admit-mode chunked`` admits prompts through fixed chunks of
``--admit-chunk`` tokens (dense family); ``--prefix-cache on`` (paged)
splices resident prompt prefixes and prefills only the suffix, on a trace
whose ``--shared-frac`` share of requests open with one
``--prefix-len``-token prompt; ``--spec-mode ngram|draft`` (both modes)
drafts ``--spec-k`` tokens a step and verifies them in one pass
(``--spec-adaptive`` moves k by acceptance; ``draft`` runs the seeded
smoke model of ``--draft-arch``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence, Tuple

import numpy as np

from ..configs import get_config, get_smoke
from ..core.mesh import mesh_and_ctx
from ..core.pcontext import AR_STRATEGIES
from ..inference.engine import GenerationResult, InferenceEngine, \
    resolve_device
from ..inference.scheduler import ContinuousBatcher, ServeMetrics, \
    make_prefix_trace, make_trace
from ..models.transformer import init_params, make_plan


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Batched generation and trace serving with the "
                    "PyTorch/CUDA port.")
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--mode", choices=("batch", "trace"), default="batch",
                   help="batch: one batch of prompts prefilled and decoded "
                        "to completion; trace: a synthetic request trace "
                        "through the continuous batcher")
    p.add_argument("--full", action="store_true",
                   help="full-size config (default: the smoke config)")
    p.add_argument("--layers", type=int, default=0,
                   help="> 0: cut the config's depth to this many layers "
                        "(widths kept)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--block-size", type=int, default=0,
                   help="> 0: paged KV cache with this many positions per "
                        "block")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="> 0 samples (each request or row from its own "
                        "chain under --seed)")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--slots", type=int, default=4,
                   help="trace: batch slots of the continuous batcher")
    p.add_argument("--s-max", type=int, default=128,
                   help="trace: positions a slot holds")
    p.add_argument("--n-blocks", type=int, default=None,
                   help="trace: paged pool blocks a rank (default: every "
                        "slot at full length plus the trash block)")
    p.add_argument("--n-requests", "--requests", dest="n_requests",
                   type=int, default=12, help="trace: requests")
    p.add_argument("--mean-in", type=int, default=12,
                   help="trace: mean prompt length")
    p.add_argument("--mean-out", type=int, default=10,
                   help="trace: mean new tokens a request")
    p.add_argument("--rate", type=float, default=2.0,
                   help="trace: mean arrivals a step")
    p.add_argument("--json-out", "--json", dest="json_out", default=None,
                   help="trace: write the metrics as JSON here")
    p.add_argument("--admit-mode", choices=("full", "chunked"),
                   default="full",
                   help="trace: admit by one full prefill, or by fixed "
                        "chunks of --admit-chunk tokens (dense family)")
    p.add_argument("--admit-chunk", type=int, default=32,
                   help="trace: tokens a chunk (--s-max a multiple of it)")
    p.add_argument("--prefix-cache", choices=("off", "on"), default="off",
                   help="trace: splice resident prompt prefixes (paged)")
    p.add_argument("--prefix-capacity", type=int, default=None,
                   help="trace: blocks the prefix cache may hold")
    p.add_argument("--shared-frac", type=float, default=None,
                   help="trace: share of requests opening with one shared "
                        "prompt (default 0.75 with --prefix-cache on)")
    p.add_argument("--prefix-len", type=int, default=32,
                   help="trace: tokens of the shared prompt")
    p.add_argument("--spec-mode", choices=("ngram", "draft"), default=None,
                   help="speculative decoding with this drafter (dense)")
    p.add_argument("--spec-k", type=int, default=4,
                   help="drafted tokens a step")
    p.add_argument("--spec-adaptive", action="store_true",
                   help="trace: move k along {2, 4, 8} by acceptance")
    p.add_argument("--draft-arch", default="llama3.2-1b",
                   help="the draft model's arch (its smoke config)")
    p.add_argument("--ar-strategy", choices=list(AR_STRATEGIES),
                   default="flat",
                   help="TP all-reduce strategy (hier_rd: the recursive-"
                        "doubling kernel on the slow axis; auto: per call "
                        "from the autotune table)")
    p.add_argument("--ar-table", default=None,
                   help="persisted autotune table (JSON) for --ar-strategy "
                        "auto")
    p.add_argument("--ar-quant", choices=["off", "int8", "int4", "auto"],
                   default="off",
                   help="quantized all-reduce wire: int8/int4 payloads with "
                        "per-group scales and error feedback on the decode "
                        "residuals (auto: per call among off/int8/int4, "
                        "needs --ar-strategy auto)")
    p.add_argument("--overlap", action="store_true",
                   help="overlapped collective-matmul projections")
    p.add_argument("--overlap-chunks", type=int, default=4,
                   help="column blocks of the overlapped projections")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (virtual mesh when > 1)")
    p.add_argument("--pods", type=int, default=1,
                   help="split --tp across this many pods (slow axis)")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the weights and the prompts")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, an error without a "
                        "card)")
    return p


def _setup(args: argparse.Namespace):
    """(device, cfg, depth note, mesh, ctx, plan, seeded model) of the
    arguments."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    depth = ""
    if 0 < args.layers < cfg.n_layers:
        depth = f" ({args.layers} of {cfg.n_layers} layers)"
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh, ctx = mesh_and_ctx(args.tp, args.pods,
                             ar_strategy=args.ar_strategy, device=device)
    ctx = ctx.replace(overlap_matmul=args.overlap,
                      overlap_chunks=args.overlap_chunks,
                      ar_quant="none" if args.ar_quant == "off"
                      else args.ar_quant)
    ap = make_plan(cfg, max(args.tp, 1))
    model = init_params(ap, seed=args.seed, device=device, mesh=mesh)
    return device, cfg, depth, mesh, ctx, ap, model


def _layout(args: argparse.Namespace, cfg, mesh, ctx) -> str:
    layout = f"paged(bs={args.block_size})" if args.block_size \
        else "recurrent" if cfg.attn_free else "dense"
    if cfg.family == "hybrid":
        layout += "+conv/ssm state"
    if mesh is not None:
        layout += (f" tp={args.tp} ({mesh.pods}x{mesh.fast}) "
                   f"ar={args.ar_strategy}")
        if ctx.ar_quant != "none":
            layout += f"/q={ctx.ar_quant}"
        if args.overlap:
            layout += f" overlap({args.overlap_chunks})"
    if args.temperature > 0:
        layout += f" T={args.temperature:g}"
        if args.top_k:
            layout += f"/top{args.top_k}"
    if args.mode == "trace" and args.admit_mode == "chunked":
        layout += f" chunked({args.admit_chunk})"
    if args.mode == "trace" and args.prefix_cache == "on":
        layout += "+prefix"
    if args.spec_mode:
        layout += f" spec={args.spec_mode}(k={args.spec_k})"
    return layout


def run_batch(args: argparse.Namespace) -> GenerationResult:
    device, cfg, depth, mesh, ctx, ap, model = _setup(args)
    s_max = args.prompt_len + args.max_new + 8
    if args.block_size:
        s_max = -(-s_max // args.block_size) * args.block_size
    eng = InferenceEngine(ap, model, ctx=ctx, mesh=mesh, s_max=s_max,
                          block_size=args.block_size, ar_table=args.ar_table,
                          temperature=args.temperature, top_k=args.top_k,
                          seed=args.seed, spec_mode=args.spec_mode,
                          spec_k=args.spec_k, draft_arch=args.draft_arch,
                          device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    res = eng.generate(prompts, args.max_new)
    layout = _layout(args, cfg, mesh, ctx)
    print(f"[serve] {cfg.name}{depth} on {device}: batch {args.batch} prompt "
          f"{args.prompt_len} new {args.max_new} {layout} "
          f"| prefill {res.prefill_s * 1e3:.1f}ms "
          f"decode {res.decode_s * 1e3:.1f}ms "
          f"({res.decode_tokens_per_s:.0f} tok/s, {res.steps} steps)")
    return res


def run_trace(args: argparse.Namespace) -> Tuple[list, ServeMetrics]:
    """One trace through one continuous batcher; returns (requests,
    metrics)."""
    device, cfg, depth, mesh, ctx, ap, model = _setup(args)
    sched = ContinuousBatcher(ap, model, slots=args.slots, s_max=args.s_max,
                              ctx=ctx, mesh=mesh, block_size=args.block_size,
                              n_blocks=args.n_blocks,
                              ar_table=args.ar_table,
                              temperature=args.temperature,
                              top_k=args.top_k, seed=args.seed,
                              admit_mode=args.admit_mode,
                              admit_chunk=args.admit_chunk,
                              prefix_cache=args.prefix_cache,
                              prefix_capacity=args.prefix_capacity,
                              spec_mode=args.spec_mode, spec_k=args.spec_k,
                              spec_adaptive=args.spec_adaptive,
                              draft_arch=args.draft_arch, device=device)
    shared = args.shared_frac if args.shared_frac is not None \
        else 0.75 if args.prefix_cache == "on" else 0.0
    kw = dict(mean_in=args.mean_in, mean_out=args.mean_out, rate=args.rate,
              vocab=cfg.vocab_size, seed=args.seed)
    reqs = make_prefix_trace(args.n_requests, prefix_len=args.prefix_len,
                             shared_frac=shared, clip_len=args.s_max - 1,
                             **kw) if shared > 0 \
        else make_trace(args.n_requests, **kw)
    done = sched.run(reqs)
    m = sched.metrics(done)
    print(f"[serve] trace {cfg.name}{depth} on {device} "
          f"[{_layout(args, cfg, mesh, ctx)}]: {m.completed}/{m.requests} "
          f"reqs, {m.total_new_tokens} tokens in {m.wall_s:.2f}s "
          f"({m.throughput_tok_s:.0f} tok/s, slots={args.slots}, "
          f"{m.steps} steps, {sched.graph_replays} replayed)")
    print(f"[serve]   TTFT p50/p99: {m.ttft_steps_p50:.1f}/"
          f"{m.ttft_steps_p99:.1f} steps = {m.ttft_s_p50 * 1e3:.1f}/"
          f"{m.ttft_s_p99 * 1e3:.1f} ms | TPOT p50/p99: "
          f"{m.tpot_steps_p50:.2f}/{m.tpot_steps_p99:.2f} steps = "
          f"{m.tpot_s_p50 * 1e3:.2f}/{m.tpot_s_p99 * 1e3:.2f} ms")
    print(f"[serve]   KV peak {m.peak_kv_tokens} tokens of "
          f"{m.kv_capacity_tokens} reserved (util "
          f"{m.cache_utilization:.2f}), {m.preemptions} preemptions")
    if args.prefix_cache == "on":
        print(f"[serve]   prefix cache: {m.prefix_hits}/{m.prefix_lookups} "
              f"admissions hit (rate {m.prefix_hit_rate:.2f}), "
              f"{m.prefix_tokens_saved} prompt tokens spliced")
    if args.spec_mode:
        print(f"[serve]   spec[{args.spec_mode} k_mean={m.spec_k_mean:.1f}"
              f"{' adaptive' if args.spec_adaptive else ''}]: "
              f"{m.accepted_tokens}/{m.drafted_tokens} drafts accepted "
              f"(rate {m.acceptance_rate:.2f}, "
              f"{m.accepted_tokens_per_step:.2f}/step), {m.spec_steps} "
              f"verify steps, drafter hit rate {m.drafter_hit_rate:.2f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(m.to_dict(), f, indent=2, default=float)
        print(f"[serve]   metrics -> {args.json_out}")
    return done, m


def main(argv: Optional[Sequence[str]] = None):
    """The batch mode's GenerationResult, or the trace mode's (requests,
    metrics)."""
    args = build_parser().parse_args(argv)
    return run_trace(args) if args.mode == "trace" else run_batch(args)


if __name__ == "__main__":
    main()
