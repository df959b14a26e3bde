"""Time kernels 4 (recursive-doubling all-reduce) and 7 (grouped expert
FFN) of one tree of this repository on one NVIDIA card, to compare two
commits in turns in one call.

    python3 chip_compare.py [ROOT [LABEL]]

ROOT (default: this file's directory) is a checkout of the repository, for
instance a parent commit unpacked with ``git archive`` into ``build/parent``.
The script imports that tree's ``chip_smoke.py`` and ``repro_torch``, builds
its kernels there and prints one line a measurement, each prefixed with
LABEL (default: ROOT):

- the timing floor: ``time_ms`` of an empty kernel (``torch.cuda._sleep``);
- kernel 4 in bf16 on 4 x 2 ranks at ``RD_SIZES`` (the tree's default
  protocol and, where the tree has them, each protocol forced and the LL
  kernel at 1, 2 and 4 packets a thread), beside ``x.view(4, 2, m).sum(0)``;
  then the LL kernel at 16 KB a rank on 8 ranks as 2 x 4, 4 x 2 and 8 x 1
  (1, 2 and 3 steps);
- kernel 7 at the MoE path's shapes and dbrx-132b's widths in bf16, and at
  the path's shapes in f32.

Every time is ``chip_smoke.time_ms`` (median of CUDA-event timed calls,
L2 flushed between calls).  Run parent, change, change, parent in one call:

    for t in build/parent . . build/parent; do python3 chip_compare.py $t; done

Exits non-zero, printing nothing, without a CUDA card.
"""
import os
import sys
import time

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                       else os.path.dirname(os.path.abspath(__file__)))
LABEL = sys.argv[2] if len(sys.argv) > 2 else ROOT
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build, moe_expert_ffn, rd_all_reduce
    from repro_torch.kernels.rd_allreduce import RDWorkspace
    from repro_torch.kernels.rd_allreduce import ops as rdo

    def log(msg: str) -> None:
        print(f"[{LABEL}] {msg}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s from {ROOT}; "
        f"{torch.cuda.get_device_name(0)}")
    log(f"floor (empty kernel) {cs.time_ms(lambda: torch.cuda._sleep(1)):.4f}")
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
            row.append(f"{name}={cs.time_ms(lambda: rd_all_reduce(x, pods, workspace=ws)):.4f}")
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
