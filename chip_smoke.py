"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the kernels from src/repro_torch/kernels/csrc and hold each
     against its plain PyTorch version on the same CUDA tensors, in bf16
     and f32, at the main path's shapes; time kernel, plain version and
     the library yardstick (scaled_dot_product_attention, timed here only);
     then the same check over the CPU tests' shape sweep, with the paged
     kernel's trash isolation and the decode kernel's blindness past pos;
  3. llama3.2-1b at full width and depth, bf16, seeded weights: batched
     generation (batch 8, prompt 512, 64 new tokens, s_max 1024) dense and
     paged (block 16) through the kernels, with launch counts checked and
     paged tokens equal to dense tokens, and one profiled dense run;
  4. the same seeded weights at full width, 2 layers, float32: the card
     (kernels) against the CPU (plain versions): prefill logits allclose,
     greedy tokens equal wherever the CPU's top-1/top-2 gap is clear.
The last two lines are the kernels' JSON record and the result line.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.kernels import (_build, decode_attention,  # noqa: E402
                                 flash_attention, kernel_wrappers,
                                 paged_decode_attention)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.models.transformer import (forward_lm,  # noqa: E402
                                            init_params, make_plan)

# Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,    # tensor cores
              torch.float32: 67e12}      # CUDA cores, no TF32
TOL = {torch.bfloat16: 3e-2, torch.float32: 3e-5}   # as tests/test_kernels.py
SEED = 0
# Main path: llama3.2-1b, batch 8, prompt 512, 64 new tokens, s_max 1024.
B, HQ, HKV, HD = 8, 32, 8, 64
PROMPT, NEW, S_MAX, BLOCK = 512, 64, 1024, 16

REPLACES = {
    "flash_attention":
        "src/repro/kernels/flash_attention/kernel.py:26",
    "decode_attention":
        "src/repro/kernels/decode_attention/kernel.py:27",
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/kernel.py:73",
}
SOURCES = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "paged_decode_attention":
        "src/repro_torch/kernels/csrc/decode_attention.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of one call, CUDA events around each call, the
    50 MB L2 flushed between calls (the model's layers find it cold)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, out, ref, dtype) -> float:
    err = max_err(out, ref)
    tol = TOL[dtype]
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    log(f"  {name} [{str(dtype)[6:]}]: max|kernel-plain| = {err:.3e} "
        f"(atol=rtol={tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        # prefill: q/k/v as the model holds them, (B, S, H, hd), passed as
        # (B, H, S, hd) views
        q = rnd(B, PROMPT, HQ, HD).transpose(1, 2)
        k = rnd(B, PROMPT, HKV, HD).transpose(1, 2)
        v = rnd(B, PROMPT, HKV, HD).transpose(1, 2)
        out = flash_attention(q, k, v, causal=True)
        ref = flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        err_f = check_close("flash_attention", out, ref, dtype)
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        t_f = (time_ms(lambda: flash_attention(q, k, v, causal=True)),
               time_ms(lambda: flash_attention_ref(q, k, v, causal=True)),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qc, kc, vc, is_causal=True, enable_gqa=True)))
        pairs = PROMPT * (PROMPT + 1) // 2
        isz = q.element_size()
        bf = bound_ms(isz * B * HD * PROMPT * (2 * HQ + 2 * HKV),
                      4.0 * B * HQ * HD * pairs, dtype)

        # decode: ragged positions over an S_MAX cache
        qd = rnd(B, HQ, HD)
        kd, vd = rnd(B, S_MAX, HKV, HD), rnd(B, S_MAX, HKV, HD)
        pos = torch.randint(0, S_MAX, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
        out = decode_attention(qd, kd, vd, pos)
        ref = decode_attention_ref(qd, kd, vd, pos)
        torch.cuda.synchronize()
        err_d = check_close("decode_attention", out, ref, dtype)
        kt, vt = kd.transpose(1, 2), vd.transpose(1, 2)
        amask = (torch.arange(S_MAX, device="cuda")[None, :]
                 <= pos[:, None].long())[:, None, None, :]
        t_d = (time_ms(lambda: decode_attention(qd, kd, vd, pos)),
               time_ms(lambda: decode_attention_ref(qd, kd, vd, pos)),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qd[:, :, None], kt, vt, attn_mask=amask,
                   enable_gqa=True)))
        n_keys = int((pos.long() + 1).sum())
        bd = bound_ms(isz * (2 * B * HQ * HD + 2 * n_keys * HKV * HD)
                      + 4 * B, 4.0 * HQ * HD * n_keys, dtype)

        # paged: the same cache scattered over a shuffled block pool
        mb = S_MAX // BLOCK
        nb = B * mb + 1
        tbl = (1 + torch.randperm(nb - 1, generator=gen, device="cuda")
               ).to(torch.int32).reshape(B, mb)
        kp = rnd(nb, BLOCK, HKV, HD)
        vp = rnd(nb, BLOCK, HKV, HD)
        out = paged_decode_attention(qd, kp, vp, tbl, pos)
        ref = paged_decode_attention_ref(qd, kp, vp, tbl, pos)
        torch.cuda.synchronize()
        err_p = check_close("paged_decode_attention", out, ref, dtype)
        t_p = (time_ms(lambda: paged_decode_attention(qd, kp, vp, tbl, pos)),
               time_ms(lambda: paged_decode_attention_ref(qd, kp, vp, tbl,
                                                          pos)),
               None)
        n_blk = int(((pos.long() + BLOCK) // BLOCK).sum())
        bp = bound_ms(isz * (2 * B * HQ * HD + 2 * n_keys * HKV * HD)
                      + 4 * B + 4 * n_blk, 4.0 * HQ * HD * n_keys, dtype)

        for name, err, t, bnd in (("flash_attention", err_f, t_f, bf),
                                  ("decode_attention", err_d, t_d, bd),
                                  ("paged_decode_attention", err_p, t_p,
                                   bp)):
            lib = "null" if t[2] is None else f"{t[2]:.4f}"
            log(f"  {name} [{str(dtype)[6:]}]: kernel_ms={t[0]:.4f} "
                f"plain_ms={t[1]:.4f} library_ms={lib} "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
            if dtype == torch.bfloat16:   # the main path's type
                rec[name] = {"max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                             "library_ms": t[2], "bound_ms": bnd[0],
                             "bound_by": bnd[1]}
    return rec


def phase_sweep() -> None:
    """The kernels against their plain versions over the shape sweep of
    the CPU tests (GQA, ragged length, window, non-causal, hd 16 to 128),
    plus the paged kernel's trash isolation and the decode kernel's
    indifference to keys past pos, both bitwise."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    f32, bf16 = torch.float32, torch.bfloat16
    for b, hq, hkv, sq, skv, hd, causal, win, dt in (
            (2, 4, 2, 128, 128, 64, True, 0, f32),
            (1, 4, 1, 200, 200, 64, True, 0, f32),
            (2, 2, 2, 256, 256, 128, True, 64, bf16),
            (1, 8, 2, 128, 384, 64, False, 0, f32),
            (2, 4, 2, 12, 12, 16, True, 0, bf16)):
        q = rnd((b, hq, sq, hd), dt)
        k, v = rnd((b, hkv, skv, hd), dt), rnd((b, hkv, skv, hd), dt)
        check_close(f"flash_attention {b},{hq},{hkv},{sq},{skv},{hd},"
                    f"causal={causal},window={win}",
                    flash_attention(q, k, v, causal=causal, window=win),
                    flash_attention_ref(q, k, v, causal=causal,
                                        window=win), dt)
    for b, hq, hkv, s, hd, win, dt in ((4, 4, 2, 512, 64, 0, f32),
                                       (3, 8, 1, 300, 128, 0, f32),
                                       (8, 2, 2, 1024, 64, 128, bf16),
                                       (2, 4, 2, 32, 16, 0, bf16)):
        q = rnd((b, hq, hd), dt)
        k, v = rnd((b, s, hkv, hd), dt), rnd((b, s, hkv, hd), dt)
        pos = torch.randint(0, s, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
        check_close(f"decode_attention {b},{hq},{hkv},{s},{hd},window={win}",
                    decode_attention(q, k, v, pos, window=win),
                    decode_attention_ref(q, k, v, pos, window=win), dt)
        keep = (torch.arange(s, device="cuda")[None, :]
                <= pos[:, None])[:, :, None, None]
        scrubbed = decode_attention(q, torch.where(keep, k, 999.0).to(dt),
                                    torch.where(keep, v, -999.0).to(dt), pos,
                                    window=win)
        if not torch.equal(scrubbed, decode_attention(q, k, v, pos,
                                                      window=win)):
            raise AssertionError("decode_attention read a key past pos")
    for b, hq, hkv, bs, mb, nb, hd, win, dt in (
            (4, 4, 2, 16, 8, 40, 64, 0, f32),
            (3, 8, 1, 32, 4, 16, 128, 0, f32),
            (2, 2, 2, 64, 4, 12, 64, 128, bf16)):
        q = rnd((b, hq, hd), dt)
        k, v = rnd((nb, bs, hkv, hd), dt), rnd((nb, bs, hkv, hd), dt)
        tbl = (1 + torch.randperm(nb - 1, generator=gen, device="cuda")
               [:b * mb]).to(torch.int32).reshape(b, mb)
        pos = torch.randint(0, mb * bs, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
        out = paged_decode_attention(q, k, v, tbl, pos, window=win)
        check_close(f"paged_decode_attention {b},{hq},{hkv},bs={bs},"
                    f"blocks={mb},{hd},window={win}", out,
                    paged_decode_attention_ref(q, k, v, tbl, pos,
                                               window=win), dt)
        # Every block no row maps at or before its pos, the trash block 0
        # included, may hold anything.
        live = torch.zeros(nb, dtype=torch.bool, device="cuda")
        for r in range(b):
            live[tbl[r, :int(pos[r]) // bs + 1].long()] = True
        k2, v2 = k.clone(), v.clone()
        k2[~live], v2[~live] = 999.0, -999.0
        if not torch.equal(out, paged_decode_attention(q, k2, v2, tbl, pos,
                                                       window=win)):
            raise AssertionError("paged_decode_attention read a dead block")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Phase 3: the whole path at full width and depth
# ---------------------------------------------------------------------------


def reset_counts() -> None:
    for w in kernel_wrappers():
        w.launches = 0


def counts() -> dict:
    return {w.__name__: w.launches for w in kernel_wrappers()}


def profile_generate(eng: InferenceEngine, prompts: np.ndarray) -> None:
    """Where one generate's time goes: device busy share of the wall time
    and the kernels that take the most device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        res = eng.generate(prompts, NEW)
    wall_ms = (res.prefill_s + res.decode_s) * 1e3
    # kernel (and memcpy/memset) events only: device time is counted once
    rows = [(e.device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("    profile: no device time recorded (not measured)")
        return
    log(f"    profile: device busy {busy:.2f} ms of {wall_ms:.2f} ms wall "
        f"({100 * busy / wall_ms:.1f}%; idle {100 - 100 * busy / wall_ms:.1f}"
        f"%) under the profiler")
    for ms, n, key in rows[:8]:
        log(f"      {ms:9.3f} ms {n:6d}x  {key[:90]}")


def phase_path() -> dict:
    cfg = get_config("llama3.2-1b")
    ap = make_plan(cfg, 1)
    model = init_params(ap, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters in {cfg.dtype}")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, PROMPT))
    L = cfg.n_layers
    expect = {"dense": {"flash_attention": L,
                        "decode_attention": L * (NEW - 1),
                        "paged_decode_attention": 0},
              "paged": {"flash_attention": L, "decode_attention": 0,
                        "paged_decode_attention": L * (NEW - 1)}}
    launches = {w.__name__: 0 for w in kernel_wrappers()}
    tokens = {}
    for layout, bsz in (("dense", 0), ("paged", BLOCK)):
        eng = InferenceEngine(ap, model, s_max=S_MAX, block_size=bsz,
                              device="cuda")
        eng.generate(prompts, 2)          # warm-up (cuBLAS, allocator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = eng.generate(prompts, NEW)
        got = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  {layout}: prefill {res.prefill_s * 1e3:.2f} ms, decode "
            f"{res.decode_s * 1e3:.2f} ms for {NEW - 1} steps "
            f"({res.decode_tokens_per_s:.1f} tok/s), peak memory "
            f"{peak:.3f} GiB, launches {got}")
        if got != expect[layout]:
            raise AssertionError(f"{layout}: launches {got}, expected "
                                 f"{expect[layout]}")
        for n, c in got.items():
            launches[n] += c
        tokens[layout] = res.new_tokens
        if layout == "dense":
            profile_generate(eng, prompts)
    if not np.array_equal(tokens["dense"], tokens["paged"]):
        raise AssertionError("paged tokens differ from dense tokens")
    log("  paged tokens == dense tokens")
    return launches


# ---------------------------------------------------------------------------
# Phase 4: card against CPU at full width, 2 layers, float32
# ---------------------------------------------------------------------------


def margin_gate(tokens_a, tokens_b, logits, prompt_len, tol) -> int:
    """Tokens must agree at every step until the first one whose reference
    top-1/top-2 logit gap is within ``tol`` (there the two may legitimately
    pick different tokens).  ``logits`` (B, S+new-1, V) are the reference's
    teacher-forced logits over its own sequence.  Returns steps checked."""
    checked = 0
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    for b in range(tokens_a.shape[0]):
        for t in range(tokens_a.shape[1] - prompt_len):
            if gap[b, prompt_len - 1 + t] <= tol:
                break
            if tokens_a[b, prompt_len + t] != tokens_b[b, prompt_len + t]:
                raise AssertionError(f"row {b} step {t}: tokens differ with "
                                     f"gap {gap[b, prompt_len - 1 + t]:.4g}")
            checked += 1
    return checked


def phase_cpu() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2,
                              dtype=torch.float32)
    ap = make_plan(cfg, 1)
    gpu = init_params(ap, seed=SEED, device="cuda")
    cpu = copy.deepcopy(gpu).to("cpu")
    b, s, new = 2, 64, 8
    prompts = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size,
                                                       (b, s))
    # f32 sums over 2048- and 8192-long reductions are taken in another
    # order on the card than on the CPU: ~1e-5 on O(1) logits.
    tol = 1e-3
    with torch.inference_mode():
        lg, _ = forward_lm(gpu, torch.as_tensor(prompts, device="cuda"), ap)
        lc, _ = forward_lm(cpu, torch.as_tensor(prompts), ap)
    err = max_err(lg.cpu(), lc)
    log(f"  prefill logits card vs CPU: max abs err {err:.3e} "
        f"(atol=rtol={tol:g})")
    if not torch.allclose(lg.cpu(), lc, atol=tol, rtol=tol):
        raise AssertionError("prefill logits differ between card and CPU")
    res_g = InferenceEngine(ap, gpu, s_max=s + new, device="cuda"
                            ).generate(prompts, new)
    res_c = InferenceEngine(ap, cpu, s_max=s + new, device="cpu"
                            ).generate(prompts, new)
    with torch.inference_mode():
        tf, _ = forward_lm(cpu, torch.as_tensor(res_c.tokens[:, :-1],
                                                dtype=torch.long), ap)
    n = margin_gate(res_g.tokens, res_c.tokens, tf, s, 2 * tol)
    log(f"  greedy tokens card == CPU on {n}/{b * new} margin-gated steps "
        f"(fully equal: {np.array_equal(res_g.tokens, res_c.tokens)})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log("[1] card (nvidia-smi name, power.limit):")
    log(smi)
    log(f"    torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
        f"({_build.BUILD_DIR})")
    for f in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in f.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {f.stem}: {line.strip()}")
    rec = phase_kernels()
    phase_sweep()
    log("[3] llama3.2-1b full width and depth, bf16")
    launches = phase_path()
    log("[4] card vs CPU, full width, 2 layers, float32")
    phase_cpu()
    kernels = [{"name": n, "route": "cuda", "source": SOURCES[n],
                "replaces": REPLACES[n], "launches": launches[n], **rec[n]}
               for n in ("flash_attention", "decode_attention",
                         "paged_decode_attention")]
    log(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
