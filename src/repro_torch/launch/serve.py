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
    python -m repro_torch.launch.serve --mode trace --device cpu \
        --block-size 8 --fault-plan seed=7,nan_logits=0.05,oom=0.1 \
        --deadline-ms 500                 # injected faults, deadlines
    python -m repro_torch.launch.serve --mode trace --device cpu \
        --block-size 8 --disagg --prefill-tp 2 --decode-tp 4 \
        --decode-pods 2 --ar-strategy hier_rd   # disaggregated pools
    python -m repro_torch.launch.serve --mode trace --device cpu \
        --replicas 2 --router-policy least_queue     # a routed fleet
    python -m repro_torch.launch.serve --arch llama3.2-1b --mode batch \
        --full --tp 8 --pods 4 --ar-strategy hier_rd --seq-parallel on
    python -m repro_torch.launch.serve --arch codeqwen1.5-7b --mode batch \
        --full --batch 8 --prompt-len 128      # a QKV-bias arch on one card
    python -m repro_torch.launch.serve --arch whisper-medium --mode batch \
        --device cpu [--tp 4 --pods 2 --ar-strategy hier_rd]  # encoder-decoder
    python -m repro_torch.launch.serve --arch pixtral-12b --mode batch \
        --device cpu [--block-size 8]          # VLM, smoke config

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
``[serve]`` line then shows the depth.  ``--seq-parallel on|auto`` keeps
the prefill's residual stream cut on the sequence over the fast TP axis
(reduce-scatter + all-gather in place of each fused all-reduce; ``auto``
asks the autotune table per call); decode never decomposes.  The dense
archs ``mistral-large-123b``, ``codeqwen1.5-7b`` and ``qwen1.5-32b`` (the
last two with QKV biases) run as ``llama3.2-1b`` does; the two larger
ones fit one card only with ``--layers``.  The encoder-decoder
``whisper-medium`` and the VLM ``pixtral-12b`` run in batch mode only
(``--mode trace`` refuses them, as the reference does): their frames or
patches are drawn from the seeded generator after the prompts, as the
reference draws them, and the prompt must be at least ``n_patches``
tokens long for the VLM (1024 at full size, 4 for the smoke config).

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
smoke model of ``--draft-arch``).  ``--fault-plan`` (a ``key=rate,...``
string or a JSON file: ``faults.FaultPlan``) injects faults and
``--deadline-ms`` sheds requests past a TTFT deadline (one logical step a
millisecond); ``--disagg`` serves through a prefill pool and a decode pool,
each its own virtual mesh (``--prefill-tp/--prefill-pods``,
``--decode-tp/--decode-pods``) and autotune table
(``--prefill-ar-table/--decode-ar-table``), joined by a checksummed KV
handoff; ``--replicas N`` places the trace over N replicas on the card by
``--router-policy``.  These are trace-mode only.

Every run is described by a :class:`~repro_torch.inference.spec.ServeSpec`
(``ServeSpec.from_args``), validated in one place and built by the
factories of :mod:`repro_torch.inference.spec`; a refused combination exits
with the field-naming message.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence, Tuple

import numpy as np

from ..configs import get_config, get_smoke
from ..core.pcontext import AR_STRATEGIES, SEQ_PARALLEL_MODES
from ..inference.engine import GenerationResult
from ..inference.router import Router, RouterMetrics
from ..inference.scheduler import ServeMetrics, make_prefix_trace, \
    make_trace
from ..inference.spec import (ROUTER_POLICIES, ServeSpec, SpecError,
                              build_engine, build_replica, spec_config)


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
    p.add_argument("--kv-quant", action="store_true",
                   help="trace: int8 KV cache with per-(pos, head) bf16 "
                        "scales (dense layout, full admission, no "
                        "speculation)")
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
    p.add_argument("--seq-parallel", choices=list(SEQ_PARALLEL_MODES),
                   default="off",
                   help="sequence-parallel prefill: the residual stays cut "
                        "on the sequence over the fast TP axis, reduce-"
                        "scatter + all-gather replacing the fused all-"
                        "reduce (auto: per call from the autotune table's "
                        "SP entries); decode never decomposes")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (virtual mesh when > 1)")
    p.add_argument("--pods", type=int, default=1,
                   help="split --tp across this many pods (slow axis)")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the weights and the prompts")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, an error without a "
                        "card)")
    # -- robustness (trace mode) --------------------------------------------
    p.add_argument("--fault-plan", default=None,
                   help="trace: deterministic fault plan, a 'key=rate,...' "
                        "string or a JSON file, e.g. "
                        "'seed=7,nan_logits=0.05,oom=0.1'")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="trace: TTFT deadline (1 logical step = 1 ms); "
                        "requests still unadmitted past it are shed and "
                        "reported")
    # -- disaggregated prefill / decode pools (trace mode) ------------------
    p.add_argument("--disagg", action="store_true",
                   help="trace: a prefill pool and a decode pool, each its "
                        "own mesh and autotune table, joined by a KV "
                        "handoff")
    p.add_argument("--prefill-tp", type=int, default=1,
                   help="prefill pool's tensor-parallel ways (--disagg)")
    p.add_argument("--prefill-pods", type=int, default=1,
                   help="prefill pool's pod split of --prefill-tp")
    p.add_argument("--decode-tp", type=int, default=1,
                   help="decode pool's tensor-parallel ways (--disagg)")
    p.add_argument("--decode-pods", type=int, default=1,
                   help="decode pool's pod split of --decode-tp")
    p.add_argument("--prefill-ar-table", default=None,
                   help="persisted autotune table of the prefill pool")
    p.add_argument("--decode-ar-table", default=None,
                   help="persisted autotune table of the decode pool")
    p.add_argument("--prefill-per-step", type=int, default=1,
                   help="prompts the prefill pool takes a logical step")
    # -- multi-replica router (trace mode) ----------------------------------
    p.add_argument("--replicas", type=int, default=1,
                   help="trace: > 1 places the trace over this many "
                        "replicas, each its own virtual mesh on the card")
    p.add_argument("--router-policy", choices=list(ROUTER_POLICIES),
                   default="round_robin",
                   help="placement for --replicas > 1: round_robin, "
                        "least_queue (fewest in flight), ttft_aware "
                        "(smallest estimated wait)")
    return p


def _depth(spec: ServeSpec) -> str:
    """The ``[serve]`` line's depth note under ``--layers``."""
    r = spec.replica
    full = (get_smoke(r.arch) if r.smoke else get_config(r.arch)).n_layers
    return f" ({r.layers} of {full} layers)" if 0 < r.layers < full else ""


def _layout(args: argparse.Namespace, cfg, mesh, ctx) -> str:
    layout = f"paged(bs={args.block_size})" if args.block_size \
        else "recurrent" if cfg.attn_free else "dense"
    if cfg.family == "hybrid":
        layout += "+conv/ssm state"
    if cfg.family == "encdec":
        layout += f"+cross K/V ({cfg.enc_seq} frames)"
    if cfg.family == "vlm":
        layout += f" ({cfg.n_patches} patches)"
    if args.kv_quant:
        layout += "+kv8"
    if mesh is not None:
        layout += (f" tp={args.tp} ({mesh.pods}x{mesh.fast}) "
                   f"ar={args.ar_strategy}")
        if ctx.ar_quant != "none":
            layout += f"/q={ctx.ar_quant}"
        if args.overlap:
            layout += f" overlap({args.overlap_chunks})"
        if ctx.seq_parallel != "off":
            layout += f" sp={ctx.seq_parallel}"
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


def run_batch(args: argparse.Namespace, spec: ServeSpec
              ) -> GenerationResult:
    """One batch of prompts through :func:`build_engine`."""
    r = spec.replica
    cfg = spec_config(r)
    s_max = args.prompt_len + args.max_new + 8
    if r.block_size:
        s_max = -(-s_max // r.block_size) * r.block_size
    eng = build_engine(r.replace(s_max=s_max), device=args.device)
    rng = np.random.default_rng(r.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    extra = {}
    if cfg.family == "encdec":
        extra["frame_embeds"] = rng.standard_normal(
            (args.batch, cfg.enc_seq, cfg.d_model))
    if cfg.family == "vlm":
        extra["patch_embeds"] = rng.standard_normal(
            (args.batch, cfg.n_patches, cfg.d_model))
    res = eng.generate(prompts, args.max_new, extra=extra)
    layout = _layout(args, cfg, eng.mesh, eng.ctx)
    print(f"[serve] {cfg.name}{_depth(spec)} on {eng.device}: batch "
          f"{args.batch} prompt {args.prompt_len} new {args.max_new} "
          f"{layout} | prefill {res.prefill_s * 1e3:.1f}ms "
          f"decode {res.decode_s * 1e3:.1f}ms "
          f"({res.decode_tokens_per_s:.0f} tok/s, {res.steps} steps)")
    return res


def _make_reqs(args: argparse.Namespace, spec: ServeSpec) -> list:
    """The trace every trace-mode deployment replays: ``make_trace``, or
    ``make_prefix_trace`` when a share of requests opens with one prompt
    (``--shared-frac``, 0.75 by default under ``--prefix-cache on``)."""
    r = spec.replica
    shared = args.shared_frac if args.shared_frac is not None \
        else 0.75 if r.prefix_cache == "on" else 0.0
    kw = dict(mean_in=args.mean_in, mean_out=args.mean_out, rate=args.rate,
              vocab=spec_config(r).vocab_size, seed=r.seed)
    if shared > 0:
        return make_prefix_trace(args.n_requests, prefix_len=args.prefix_len,
                                 shared_frac=shared, clip_len=r.s_max - 1,
                                 **kw)
    return make_trace(args.n_requests, **kw)


def _check_outcomes(done: list, armed: bool) -> None:
    """Never silently dropped: without faults or a deadline every request
    completes; with them each either completes or is shed with a
    reason."""
    if not armed:
        lost = [r.rid for r in done if r.output is None]
    else:
        lost = [r.rid for r in done
                if r.output is None and r.shed_reason is None]
    if lost:
        raise RuntimeError(f"requests silently dropped: {lost}")


def _print_faults(injector, shed: list) -> None:
    """The faults that fired and the shed requests by reason."""
    if injector is not None:
        fired = {k: v for k, v in injector.stats().items() if v}
        print(f"[serve]   faults injected: {fired or 'none'}")
    if shed:
        reasons: dict = {}
        for r in shed:
            reasons[r.shed_reason] = reasons.get(r.shed_reason, 0) + 1
        print(f"[serve]   shed {len(shed)} request(s): {reasons}")


def _write_json(m, json_out: Optional[str]) -> None:
    if json_out:
        with open(json_out, "w") as f:
            json.dump(m.to_dict(), f, indent=2, default=float)
        print(f"[serve]   metrics -> {json_out}")


def _print_latency(m) -> None:
    print(f"[serve]   TTFT p50/p99: {m.ttft_steps_p50:.1f}/"
          f"{m.ttft_steps_p99:.1f} steps = {m.ttft_s_p50 * 1e3:.1f}/"
          f"{m.ttft_s_p99 * 1e3:.1f} ms | TPOT p50/p99: "
          f"{m.tpot_steps_p50:.2f}/{m.tpot_steps_p99:.2f} steps = "
          f"{m.tpot_s_p50 * 1e3:.2f}/{m.tpot_s_p99 * 1e3:.2f} ms")


def run_trace(args: argparse.Namespace, spec: ServeSpec
              ) -> Tuple[list, ServeMetrics]:
    """One trace through one colocated :func:`build_replica` batcher;
    returns (requests, metrics)."""
    r = spec.replica
    sched = build_replica(r, device=args.device)
    cfg = sched.cfg
    done = sched.run(_make_reqs(args, spec))
    _check_outcomes(done, sched.injector is not None
                    or r.deadline_ms is not None)
    m = sched.metrics(done)
    print(f"[serve] trace {cfg.name}{_depth(spec)} on {sched.device} "
          f"[{_layout(args, cfg, sched.mesh, sched.ctx)}]: {m.completed}/"
          f"{m.requests} reqs, {m.total_new_tokens} tokens in "
          f"{m.wall_s:.2f}s ({m.throughput_tok_s:.0f} tok/s, "
          f"slots={r.slots}, {m.steps} steps, {sched.graph_replays} "
          "replayed)")
    _print_latency(m)
    print(f"[serve]   KV peak {m.peak_kv_tokens} tokens of "
          f"{m.kv_capacity_tokens} reserved (util "
          f"{m.cache_utilization:.2f}), {m.preemptions} preemptions")
    if r.prefix_cache == "on":
        print(f"[serve]   prefix cache: {m.prefix_hits}/{m.prefix_lookups} "
              f"admissions hit (rate {m.prefix_hit_rate:.2f}), "
              f"{m.prefix_tokens_saved} prompt tokens spliced")
    if r.spec_mode:
        print(f"[serve]   spec[{r.spec_mode} k_mean={m.spec_k_mean:.1f}"
              f"{' adaptive' if r.spec_adaptive else ''}]: "
              f"{m.accepted_tokens}/{m.drafted_tokens} drafts accepted "
              f"(rate {m.acceptance_rate:.2f}, "
              f"{m.accepted_tokens_per_step:.2f}/step), {m.spec_steps} "
              f"verify steps, drafter hit rate {m.drafter_hit_rate:.2f}")
    if sched.injector is not None or m.shed_requests:
        print(f"[serve]   robustness: {m.quarantines} quarantines, "
              f"{m.injected_oom} injected OOM, {m.straggler_steps} "
              f"straggler steps, {m.spec_autodisables} spec autodisables, "
              f"{m.wasted_tokens} tokens recomputed")
        _print_faults(sched.injector, sched._shed)
    _write_json(m, args.json_out)
    return done, m


def run_disagg(args: argparse.Namespace, spec: ServeSpec):
    """Disaggregated trace serving: one :func:`build_replica` coordinator
    over a prefill pool and a decode pool, each its own mesh and autotune
    table (``ar_table`` seeds both where a pool's own is not given);
    returns (requests, metrics)."""
    r = spec.replica
    coord = build_replica(r, device=args.device)
    decode, injector = coord.decode, coord.injector
    done = coord.run(_make_reqs(args, spec))
    _check_outcomes(done, injector is not None or r.deadline_ms is not None)
    m = coord.metrics(done)
    layout = f"paged(bs={r.block_size})" if decode.paged else "dense"
    sp = f" spec={r.spec_mode}(k={r.spec_k})" if r.spec_mode else ""
    print(f"[serve] disagg {decode.cfg.name}{_depth(spec)} on "
          f"{decode.device} [{layout} ar={r.ar_strategy} prefill "
          f"tp={r.prefill_tp}x{r.prefill_pods} {r.admit_mode} decode "
          f"tp={r.decode_tp}x{r.decode_pods}{sp}]: {m.completed}/"
          f"{m.requests} reqs, {m.total_new_tokens} tokens in "
          f"{m.wall_s:.2f}s ({m.throughput_tok_s:.0f} tok/s, {m.steps} "
          "decode steps)")
    print(f"[serve]   TTFT p50/p99: {m.ttft_steps_p50:.1f}/"
          f"{m.ttft_steps_p99:.1f} steps (prefill {m.prefill_steps_p50:.1f}"
          f" + transfer {m.transfer_steps_p50:.1f} at p50) | TPOT p50/p99: "
          f"{m.tpot_steps_p50:.2f}/{m.tpot_steps_p99:.2f} steps "
          "[decode pool]")
    print(f"[serve]   handoff: {m.handoffs} bundles, "
          f"{m.transfer_bytes / 1024:.0f} KiB, ready/pending queue peaks "
          f"{m.peak_ready_depth}/{m.peak_pending_depth}, "
          f"{m.preemptions} decode-pool preemptions")
    print(f"[serve]   AR buckets: prefill pool 2^{m.prefill_ar_bucket} vs "
          f"decode pool 2^{m.decode_ar_bucket} (prefill "
          f"{m.prefill_pool['ar_buckets_analytic']} analytic, "
          f"{m.prefill_pool['ar_buckets_dispatched']} dispatched); graph "
          f"captures prefill {m.prefill_pool['graph_captures']} / decode "
          f"{m.decode_pool['graph_captures']} ("
          f"{m.prefill_pool['graph_recaptures']} / "
          f"{m.decode_pool['graph_recaptures']} anew)")
    if injector is not None or m.shed_requests:
        print(f"[serve]   robustness: {m.handoff_drops} drops / "
              f"{m.handoff_retries} retries / {m.handoff_corrupt} corrupt "
              f"/ {m.handoff_reprefills} re-prefills, "
              f"{m.backpressure_steps} backpressure steps (ready cap "
              f"{m.ready_cap}), stalls prefill={m.prefill_stall_steps} "
              f"decode={m.decode_stall_steps}")
        _print_faults(injector, coord._shed + decode._shed)
    _write_json(m, args.json_out)
    return done, m


def run_router(args: argparse.Namespace, spec: ServeSpec
               ) -> Tuple[list, RouterMetrics]:
    """Multi-replica trace serving: ``spec.replicas`` replicas placed by
    ``spec.router_policy``, reported per replica and as their lossless
    merge; returns (requests, router metrics)."""
    r = spec.replica
    router = Router.from_spec(spec, device=args.device)
    done = router.run(_make_reqs(args, spec))
    injectors = [rep.injector for rep in router.replicas]
    _check_outcomes(done, injectors[0] is not None
                    or r.deadline_ms is not None)
    rm = router.metrics(done)
    m = rm.fleet
    kind = "disagg" if r.disagg else f"tp={r.tp}" if r.tp > 1 else "local"
    print(f"[serve] router {r.arch} [{spec.replicas}x {kind} "
          f"policy={spec.router_policy}]: {m.completed}/{m.requests} reqs, "
          f"{m.total_new_tokens} tokens in {m.wall_s:.2f}s "
          f"({m.throughput_tok_s:.0f} tok/s, {m.steps} steps)")
    print(f"[serve]   fleet TTFT p50/p99: {m.ttft_steps_p50:.1f}/"
          f"{m.ttft_steps_p99:.1f} steps | TPOT p50/p99: "
          f"{m.tpot_steps_p50:.2f}/{m.tpot_steps_p99:.2f} steps")
    print(f"[serve]   placements {rm.placements} "
          f"(imbalance {rm.load_imbalance:.2f}), preemptions "
          f"{m.preemptions}, shed {m.shed_requests}")
    for i, pm in enumerate(rm.per_replica):
        print(f"[serve]   replica {i}: {pm.completed}/{pm.requests} reqs, "
              f"TTFT p99 {pm.ttft_steps_p99:.1f}, "
              f"{pm.total_new_tokens} tokens")
    for i, inj in enumerate(injectors):
        if inj is not None:
            fired = {k: v for k, v in inj.stats().items() if v}
            print(f"[serve]   replica {i} faults: {fired or 'none'}")
    _write_json(rm, args.json_out)
    return done, rm


def main(argv: Optional[Sequence[str]] = None):
    """The batch mode's GenerationResult, or the trace modes' (requests,
    metrics).  A combination ``ServeSpec.validate`` refuses exits with its
    message."""
    args = build_parser().parse_args(argv)
    try:
        spec = ServeSpec.from_args(args)
    except SpecError as e:
        raise SystemExit(str(e))
    if ServeSpec.from_json(spec.to_json()) != spec:
        raise RuntimeError("the serve spec does not survive its JSON round "
                           "trip")
    if spec.mode == "batch":
        return run_batch(args, spec)
    if spec_config(spec.replica).family in ("encdec", "vlm"):
        raise SystemExit("trace mode supports text-only archs")
    if spec.replicas > 1:
        return run_router(args, spec)
    if spec.replica.disagg:
        return run_disagg(args, spec)
    return run_trace(args, spec)


if __name__ == "__main__":
    main()
