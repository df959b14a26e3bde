"""Time kernels of one tree of this repository on one NVIDIA card, to
compare two commits in turns in one call.

    python3 chip_compare.py [ROOT [LABEL [SECTIONS]]]

ROOT (default: this file's directory) is a checkout of the repository, for
instance a parent commit unpacked with ``git archive`` into ``build/parent``.
The script imports that tree's ``chip_smoke.py`` and ``repro_torch``, builds
its kernels there and prints one line a measurement, each prefixed with
LABEL (default: ROOT).  SECTIONS (default ``rd,moe,quant``) picks among:

- ``rd``: kernel 4 (recursive-doubling all-reduce) in bf16 on 4 x 2 ranks
  at ``RD_SIZES`` (the tree's default protocol and, where the tree has
  them, each protocol forced and the LL kernel at 1, 2 and 4 packets a
  thread), beside ``x.view(4, 2, m).sum(0)``; then the LL kernel at 16 KB
  a rank on 8 ranks as 2 x 4, 4 x 2 and 8 x 1 (1, 2 and 3 steps);
- ``moe``: kernel 7 (grouped expert FFN) at the MoE path's shapes and
  dbrx-132b's widths in bf16, and at the path's shapes in f32;
- ``quant``: the quantized wire on the 4 x 2 ``hier_rd`` mesh: one
  ``tp_all_reduce`` at the decode message (bf16, error feedback on) and
  the prefill message, int8 and int4; the slow phase alone
  (``hierarchical.quant_rd_all_reduce`` on one rank's f32 shard);
  kernel 6's standalone pack and unpack at the prefill reduce-scatter
  shape; then llama3.2-1b at tp=8 on the int8 and int4 wire: the decode
  path's teacher-forced logits (error feedback on) over a seeded
  sequence, printed as a SHA-256 of their bytes (equal digests: bitwise
  equal logits), and one generate's prefill ms and decode tok/s;
- ``scan``: kernels 8 (RWKV6 scan) and 9 (selective scan) at their paths'
  prefill, decode and tp=8-fold shapes (``RWKV_SHAPES``, ``SSM_SHAPES``;
  kernel 9's prefill from a zero state, its decode step in place, as the
  paths call them) and, as the decode steps' yardstick, one copy of each
  decode state; then rwkv6-7b's and hymba-1.5b's tp=1 prefill at full
  width and depth (batch 8, prompts 512 and 1280; the median of three).

Every time is ``chip_smoke.time_ms`` (median of CUDA-event timed calls,
L2 flushed between calls).  Run parent, change, change, parent in one call:

    for t in build/parent . . build/parent; do python3 chip_compare.py $t; done

Exits non-zero, printing nothing, without a CUDA card.
"""
import hashlib
import inspect
import os
import sys
import time

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                       else os.path.dirname(os.path.abspath(__file__)))
LABEL = sys.argv[2] if len(sys.argv) > 2 else ROOT
SECTIONS = (sys.argv[3] if len(sys.argv) > 3 else "rd,moe,quant").split(",")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402


def log(msg: str) -> None:
    print(f"[{LABEL}] {msg}", flush=True)


def section_rd(cs) -> None:
    from repro_torch.kernels import rd_all_reduce
    from repro_torch.kernels.rd_allreduce import RDWorkspace
    from repro_torch.kernels.rd_allreduce import ops as rdo
    ws = RDWorkspace()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 3)
    forced = hasattr(rdo, "PROTOCOL")
    variants = [("default", None, None)]
    if forced:
        variants += [("ll/ppt1", "ll", (1,)), ("ll/ppt2", "ll", (2,)),
                     ("ll/ppt4", "ll", (4,)), ("simple", "simple", None)]
        plan = (rdo.PROTOCOL, rdo.LL_PPT)
    pods, fast = cs.PODS, cs.FAST
    for nbytes in cs.RD_SIZES:
        x = torch.randn((pods * fast, nbytes // 2), generator=gen,
                        device="cuda").to(torch.bfloat16)
        ref = cs.rd_all_reduce_ref(x, pods)
        row = []
        for name, proto, ppt in variants:
            if forced:
                rdo.PROTOCOL = proto
                rdo.LL_PPT = ppt or plan[1]
            if not torch.equal(rd_all_reduce(x, pods, workspace=ws), ref):
                raise AssertionError(f"kernel 4 {name} {nbytes} B differs")
            ms = cs.time_ms(lambda: rd_all_reduce(x, pods, workspace=ws))
            row.append(f"{name}={ms:.4f}")
        if forced:
            rdo.PROTOCOL, rdo.LL_PPT = plan
        lib = cs.time_ms(lambda: x.view(pods, fast, -1).sum(0))
        log(f"kernel 4 {nbytes // 1024} KB a rank: {' '.join(row)} "
            f"library={lib:.4f}")
    if forced:
        for p, f in ((2, 4), (4, 2), (8, 1)):
            x = torch.randn((8, cs.RD_SIZES[0] // 2), generator=gen,
                            device="cuda").to(torch.bfloat16)
            log(f"kernel 4 16 KB a rank, {p} pods x {f}: "
                f"{cs.time_ms(lambda: rd_all_reduce(x, p, workspace=ws)):.4f}")


def section_moe(cs) -> None:
    from repro_torch.kernels import moe_expert_ffn
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 15)
    for dtype in (torch.bfloat16, torch.float32):
        shapes = dict(cs.MOE_SHAPES)
        if dtype == torch.bfloat16:
            shapes.update(cs.MOE_WIDE)
        for name, shape in shapes.items():
            ops = cs.moe_operands(gen, *shape, dtype)
            t = cs.time_ms(lambda: moe_expert_ffn(*ops), reps=10)
            log(f"kernel 7 {name} {shape} {str(dtype)[6:]}: {t:.4f}")
            del ops
            cs.free_device()


def section_quant(cs) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core import hierarchical as H
    from repro_torch.core.mesh import mesh_and_ctx
    from repro_torch.inference.engine import InferenceEngine
    from repro_torch.kernels import quantize_pack, unpack_dequant
    from repro_torch.models.transformer import init_params, make_plan
    R = cs.PODS * cs.FAST
    mesh, ctx = mesh_and_ctx(R, cs.PODS, ar_strategy="hier_rd",
                             device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 21)
    slow_kw = ({"workspace": mesh.workspace} if "workspace" in
               inspect.signature(H.quant_rd_all_reduce).parameters else {})
    for stage, shape in (("decode", (cs.B, 1, cs.D_MODEL)),
                         ("prefill", (cs.B, cs.PROMPT, cs.D_MODEL))):
        x = torch.randn((R, *shape), generator=gen,
                        device="cuda").to(torch.bfloat16)
        ef = 0.01 * torch.randn((R, *shape), generator=gen, device="cuda")
        t = torch.randn((cs.PODS, cs.FAST, x[0].numel() // cs.FAST),
                        generator=gen, device="cuda")
        for quant in ("int8", "int4"):
            qctx = ctx.replace(ar_quant=quant)
            bits = H.QUANT_BITS[quant]
            kw = {"ef": ef} if stage == "decode" else {}
            ar = cs.time_ms(lambda: H.tp_all_reduce(x, qctx, mesh, **kw))
            slow = cs.time_ms(lambda: H.quant_rd_all_reduce(t, 0, bits,
                                                            **slow_kw))
            log(f"quantized tp_all_reduce {stage} {tuple(x.shape)} bf16 "
                f"{quant}{' EF' if kw else ''}: {ar:.4f}; slow phase "
                f"{tuple(t.shape)} f32: {slow:.4f}")
    rows, D = cs.QP_SHAPES["prefill_rs"]
    x = torch.randn((rows, D), generator=gen, device="cuda")
    for bits, group in ((8, 128), (4, 64)):
        q, s = quantize_pack(x, bits, group)
        pack = cs.time_ms(lambda: quantize_pack(x, bits, group))
        unpack = cs.time_ms(lambda: unpack_dequant(q, s, bits, group))
        log(f"kernel 6 prefill_rs {rows}x{D} bits={bits}: pack {pack:.4f} "
            f"unpack {unpack:.4f}")
    del x, q, s, t, ef
    cfg = get_config("llama3.2-1b")
    ap = make_plan(cfg, R)
    model = init_params(ap, seed=cs.SEED, device="cuda", mesh=mesh)
    rng = np.random.default_rng(cs.SEED)
    prompts = rng.integers(0, cfg.vocab_size, (cs.B, cs.PROMPT))
    seq = rng.integers(0, cfg.vocab_size, (cs.B, cs.PROMPT + cs.NEW))
    for quant in ("int8", "int4"):
        qctx = ctx.replace(ar_quant=quant)
        lg = cs.teacher_forced_decode(model, seq, ap, qctx, mesh)
        digest = hashlib.sha256(lg.float().contiguous().cpu().numpy()
                                .tobytes()).hexdigest()[:16]
        eng = InferenceEngine(ap, model, ctx=qctx, mesh=mesh, s_max=cs.S_MAX,
                              device="cuda")
        eng.generate(prompts, 2)
        res = eng.generate(prompts, cs.NEW)
        log(f"llama3.2-1b tp=8 hier_rd {quant}: teacher-forced decode "
            f"logits sha256 {digest} (max |logit| "
            f"{float(lg.float().abs().max()):.4f}); prefill "
            f"{res.prefill_s * 1e3:.2f} ms, decode "
            f"{res.decode_tokens_per_s:.1f} tok/s")
    del model
    cs.free_device()


def section_scan(cs) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_scan, ssm_scan
    from repro_torch.models.transformer import init_params, make_plan
    from repro_torch.inference.engine import InferenceEngine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 22)
    for name, shape in cs.RWKV_SHAPES.items():
        ops = cs.rwkv_operands(gen, *shape)
        log(f"kernel 8 {name} {shape}: "
            f"{cs.time_ms(lambda: rwkv6_scan(*ops)):.4f}")
        if name == "decode":
            log(f"  a copy of its state {tuple(ops[5].shape)}: "
                f"{cs.time_ms(lambda: ops[5].clone()):.4f}")
    for name, shape in cs.SSM_SHAPES.items():
        x, dt, b, c, a, h0 = cs.ssm_operands(gen, *shape)
        if name == "decode":
            t = cs.time_ms(lambda: ssm_scan(x, dt, b, c, a, h0, h_out=h0))
            log(f"  a copy of its state {tuple(h0.shape)}: "
                f"{cs.time_ms(lambda: h0.clone()):.4f}")
        else:
            t = cs.time_ms(lambda: ssm_scan(x, dt, b, c, a))
        log(f"kernel 9 {name} {shape}: {t:.4f}")
    del ops, x, dt, b, c, a, h0
    for arch, prompt in ((cs.RWKV_ARCH, cs.PROMPT),
                         (cs.HYB_ARCH, cs.HYB_PROMPT)):
        cs.free_device()
        ap = make_plan(get_config(arch), 1)
        model = init_params(ap, seed=cs.SEED, device="cuda")
        prompts = np.random.default_rng(cs.SEED).integers(
            0, ap.cfg.vocab_size, (cs.B, prompt))
        eng = InferenceEngine(ap, model, s_max=prompt + 2, device="cuda")
        eng.generate(prompts, 1)
        ms = [eng.generate(prompts, 1).prefill_s * 1e3 for _ in range(3)]
        log(f"{arch} tp=1 prefill (B {cs.B}, prompt {prompt}): "
            f"{np.median(ms):.2f} ms ({' '.join(f'{m:.2f}' for m in ms)})")
        del model, eng
    cs.free_device()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s from {ROOT}; "
        f"{torch.cuda.get_device_name(0)}")
    log(f"floor (empty kernel) {cs.time_ms(lambda: torch.cuda._sleep(1)):.4f}")
    sections = {"rd": section_rd, "moe": section_moe, "quant": section_quant,
                "scan": section_scan}
    for name in SECTIONS:
        sections[name](cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
