"""The port's quantized wire outside the collectives: the group-quantized
pack/unpack (kernel 6's plain version through its wrapper on the CPU)
against the JAX package's ``kernels/rd_allreduce/quant.py`` bit for bit,
the quantized dispatch of the autotuner and its comm-model terms against
the JAX package's, the error-feedback cache leaf, teacher-forced decode
of the reference's case C config (``tests/dist_cases/case_quant_ar.py``)
against the JAX decode step, and ``generate`` / ``serve`` with
``--ar-quant`` on the CPU."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import autotune as JA  # noqa: E402
from repro.core import comm_model as JCM  # noqa: E402
from repro.kernels.rd_allreduce import quant as JQ  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.core import autotune as TA  # noqa: E402
from repro_torch.core import comm_model as TCM  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.core.pcontext import ParallelCtx as TCtx  # noqa: E402
from repro_torch.kernels import kernel_wrappers  # noqa: E402
from repro_torch.kernels import quant_pack as TQ  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.parallel.steps import (build_decode_step,  # noqa: E402
                                        build_prefill)
from test_torch_quant_collectives import COMPILE  # noqa: E402
from test_torch_tp import TPCase, _cfgs  # noqa: E402

torch.set_num_threads(1)

# tests/test_kernels.py's QP_CASES (bits, group, rows, D), plus group 1
QP_CASES = [(8, 128, 4, 512), (8, 64, 1, 256), (4, 64, 4, 384),
            (4, 128, 2, 128), (8, 1, 3, 64), (4, 1, 3, 64)]
SIZES = [2 ** p for p in range(10, 27)] + [3 * 2 ** p for p in range(9, 25)]


def _qp_input(case):
    bits, group, R, D = case
    rng = np.random.default_rng(bits * group + D)
    x = (rng.standard_normal((R, D)) * 3.0).astype(np.float32)
    x[0, :4] = [0.5 * 127 / 3, 2.5, -3.5, 1e-38]
    return x


@functools.lru_cache(maxsize=None)
def _jax_qp():
    """The reference's pack and unpack of every case, in f32 and from
    bf16, in one function compiled without the algebraic simplifier (see
    tests/test_torch_quant_collectives.py)."""
    xs = [_qp_input(c) for c in QP_CASES]

    def everything(xs):
        out = []
        for (bits, group, _, _), x in zip(QP_CASES, xs):
            for xt in (x, x.astype(jnp.bfloat16)):
                q, s = JQ.quantize_pack(xt, bits, group)
                out.append((q, s.astype(jnp.float32),
                            JQ.unpack_dequant(q, s, bits, group)))
        return out

    f = jax.jit(everything)
    res = f.lower(xs).compile(compiler_options=COMPILE)(xs)
    return jax.tree.map(np.asarray, res)


@pytest.mark.parametrize("case", QP_CASES,
                         ids=[f"b{b}g{g}" for b, g, _, _ in QP_CASES])
def test_pack_unpack_match_jax_bitwise(case):
    """Payload (nibble layout included), bf16 scales and f32 dequant equal
    the reference's, with ties and the bf16 inputs the wire also sees;
    the wrapper on CPU tensors launches nothing."""
    bits, group, R, D = case
    x = torch.tensor(_qp_input(case))
    want = _jax_qp()[2 * QP_CASES.index(case):2 * QP_CASES.index(case) + 2]
    before = [w.launches for w in kernel_wrappers()]
    for xt, (qj, sj, dj) in zip((x, x.to(torch.bfloat16)), want):
        q, s = TQ.quantize_pack(xt, bits, group)
        np.testing.assert_array_equal(q.numpy(), qj)
        np.testing.assert_array_equal(s.float().numpy(), sj)
        assert q.shape == (R, TQ.packed_width(D, bits))
        np.testing.assert_array_equal(
            TQ.unpack_dequant(q, s, bits, group).numpy(), dj)
    assert [w.launches for w in kernel_wrappers()] == before


@pytest.mark.parametrize("bits", [8, 4])
def test_nan_inf_poison_exactly_their_group(bits):
    """A non-finite value makes its own group's scale non-finite, so the
    whole group dequantizes non-finite, and leaves every other group
    bitwise as without it (as the reference: no masking)."""
    group, D = 64, 256
    x = np.random.default_rng(0).standard_normal((1, D)).astype(np.float32)
    clean = TQ.unpack_dequant(*TQ.quantize_pack(torch.tensor(x), bits,
                                                group), bits, group)
    for bad in (np.nan, np.inf, -np.inf):
        xb = x.copy()
        xb[0, 70] = bad                                   # group 1
        q, s = TQ.quantize_pack(torch.tensor(xb), bits, group)
        sj = JQ.quantize_pack(jnp.asarray(xb), bits, group)[1]
        np.testing.assert_array_equal(np.isfinite(s.float().numpy()),
                                      np.isfinite(np.asarray(sj,
                                                             np.float32)))
        out = TQ.unpack_dequant(q, s, bits, group)
        assert not torch.isfinite(out[0, 64:128]).any()
        keep = torch.ones(D, dtype=torch.bool)
        keep[64:128] = False
        assert torch.equal(out[0, keep], clean[0, keep])


def test_pack_wrapper_checks_and_helpers():
    x = torch.zeros(2, 96)
    for bad in (dict(bits=2, group=32), dict(bits=8, group=3),
                dict(bits=8, group=256), dict(bits=8, group=64)):
        with pytest.raises(ValueError):
            TQ.quantize_pack(x, **bad)
    with pytest.raises(ValueError, match="nibble"):
        TQ.quantize_pack(torch.zeros(2, 7), 4, 1)
    q, s = TQ.quantize_pack(x, 8, 32)
    with pytest.raises(ValueError, match="scales"):
        TQ.unpack_dequant(q, s[:, :1], 8, 32)
    assert torch.equal(TQ.unpack_dequant(q, s, 8, 32), x)   # zeros exact
    for n, bits in ((1024, 8), (96, 4), (7, 8), (0, 4), (640, 4)):
        assert TQ.group_for(n, bits) == JQ.group_for(n, bits)
        assert TQ.wire_factor(bits, 64) == JQ.wire_factor(bits, 64)


@pytest.mark.parametrize("quant", ["int8", "int4", "auto"])
@pytest.mark.parametrize("net", ["perlmutter", "tpu_v5e"])
def test_quant_tuner_matches_jax(net, quant):
    """Predictions, picks, lookups and tables of quantized dispatch equal
    the reference's over 1 KB - 64 MB and four topologies, and refined
    quantized winners keep rd_chunks = 1 as there."""
    jt, tt = JA.AutoTuner(JCM.NETWORKS[net]), TA.AutoTuner(TCM.NETWORKS[net])
    for fast, slow in ((1, 2), (2, 2), (2, 4), (4, 2)):
        for b in SIZES:
            assert TA.predict_quant_times(b, fast, slow, tt.net) == \
                JA.predict_quant_times(b, fast, slow, jt.net)
            assert dataclasses.asdict(tt.choose(b, fast, slow, "bfloat16",
                                                quant=quant)) == \
                dataclasses.asdict(jt.choose(b, fast, slow, "bfloat16",
                                             quant=quant))
    for t in (jt, tt):
        t.record(2 ** 24, 2, 4, "bfloat16", "hier_rd", 1e-4, quant="int4",
                 policy=quant)
        t.record(2 ** 24, 2, 4, "bfloat16", "hier_rd", 2e-4, quant="none",
                 policy=quant)
        t.refine()
    assert tt.lookups == jt.lookups
    assert tt.to_json()["table"] == jt.to_json()["table"]
    assert TCM.quant_wire_factor(4) == JCM.quant_wire_factor(4)
    for bits in (8, 4):
        assert TCM.t_quant_hier_allreduce(2 ** 20, 4, 2, tt.net, bits) == \
            JCM.t_quant_hier_allreduce(2 ** 20, 4, 2, jt.net, bits)


def test_auto_quant_resolution_writes_the_level_back():
    """Under ``ar_quant="auto"`` the resolved ctx carries the tuner's
    level (none at the 32 KB decode message, int4 at the 16 MB prefill
    one on PERLMUTTER) and the memo keys on it; a forced level survives
    resolution."""
    ctx = TCtx(tp_fast=("model",), tp_slow=("pod",), ar_strategy="auto",
               ar_quant="auto")
    with TA.using(TA.AutoTuner()):
        dec = TA.resolve(ctx, 32768, 2, 4, "bfloat16")
        pre = TA.resolve(ctx, 2 ** 24, 2, 4, "bfloat16")
        forced = TA.resolve(ctx.replace(ar_quant="int8"), 32768, 2, 4,
                            "bfloat16")
    assert (dec.ar_strategy, dec.ar_quant) == ("hier_rd", "none")
    assert (pre.ar_strategy, pre.ar_quant, pre.rd_chunks) == \
        ("hier_rd", "int4", 1)
    assert forced.ar_quant == "int8"


def test_ef_leaf_init_seed_and_sites():
    tcfg = _cfgs()[1]
    mesh, ctx = mesh_and_ctx(4, 2, ar_strategy="hier_rd", device="cpu")
    ap = TT.make_plan(tcfg, 4)
    assert TT.ef_sites_for(ctx, tcfg) == 0
    assert TT.ef_sites_for(ctx.replace(ar_quant="int4"), tcfg) == 2
    assert TT.ef_sites_for(TCtx(tp_fast=("model",), ar_strategy="auto",
                                ar_quant="auto"), tcfg) == 2
    cache = TT.init_cache(ap, 3, 16, device="cpu", mesh=mesh, ef_sites=2)
    assert cache["ef"].shape == (tcfg.n_layers, 2, 4, 3, tcfg.d_model)
    assert cache["ef"].dtype == torch.float32
    assert "ef" not in TT.init_cache(ap, 3, 16, device="cpu", mesh=mesh)
    cache["ef"].fill_(1.0)
    states = {n: torch.zeros(tcfg.n_layers, 4 * 3, 8, ap.gqa.u,
                             tcfg.head_dim) for n in ("k", "v")}
    assert not TT.seed_cache(cache, states)["ef"].any()


# ---------------------------------------------------------------------------
# Teacher-forced decode of the reference's case C
# ---------------------------------------------------------------------------

CASE_C = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
              head_dim=32, d_ff=256, vocab_size=96)
SLOTS, WARM, GREEDY, S_MAX = 4, 8, 8, 64
CASE_C_RTOL = {"int8": 0.08, "int4": 0.6}


def _port_decode(case, quant, tokens):
    """Logits (steps, R, SLOTS, V_local) of the port's decode steps from an
    empty cache, fed ``tokens`` (steps, SLOTS)."""
    ctx = case.ctx.replace(ar_quant=quant)
    cache = TT.init_cache(case.tap, SLOTS, S_MAX, device="cpu",
                          mesh=case.mesh,
                          ef_sites=TT.ef_sites_for(ctx, case.tcfg))
    out = []
    with torch.inference_mode():
        for t, tok in enumerate(tokens):
            lg, cache = TT.decode_step(
                case.model, cache, torch.tensor(tok).long(),
                torch.full((SLOTS,), t, dtype=torch.int32), case.tap, ctx,
                case.mesh)
            out.append(lg.numpy())
    if quant != "none":
        assert cache["ef"].abs().max() > 0
    return np.stack(out)


def _jax_decode(case, quant, tokens):
    """The JAX decode_step over the same steps under nested vmap, each
    rank with its own local cache and EF leaf (one step compiled, called
    per step)."""
    ap = case.jap
    ctx = case.jctx.replace(ar_quant=quant)

    def step(p, c, tok, pos):
        return JT.decode_step(p, c, tok, pos, ap, ctx)

    f = jax.jit(jax.vmap(jax.vmap(step, in_axes=(0, 0, None, None),
                                  axis_name="model"),
                         in_axes=(0, 0, None, None), axis_name="pod"))
    tree = jax.tree.map(lambda a: a.reshape(case.pods, case.fast,
                                            *a.shape[1:]), case.local)
    cache = jax.tree.map(
        lambda a: np.zeros((case.pods, case.fast) + a.shape, a.dtype),
        jax.eval_shape(lambda: JT.init_cache(ap, SLOTS, S_MAX, ef_sites=2)))
    pos = jnp.zeros((SLOTS,), jnp.int32)
    run = f.lower(tree, cache, jnp.asarray(tokens[0]), pos).compile(
        compiler_options=COMPILE)
    out = []
    for t in range(tokens.shape[0]):
        lg, cache = run(tree, cache, jnp.asarray(tokens[t]),
                        jnp.full((SLOTS,), t, jnp.int32))
        out.append(np.asarray(lg).reshape(case.pods * case.fast,
                                          *lg.shape[2:]))
    return np.stack(out)                             # (steps, R, SLOTS, V)


def test_case_c_teacher_forced_decode_matches_jax_and_fp():
    """quant-tiny at tp=8 (2 pods x 4), hier_rd, EF on: the prompt for
    WARM steps, then the fp run's greedy tokens, so every level scores the
    same trajectory.  Each level's logits stay within case C's bound of
    the port's fp logits and of the JAX decode step's at that level."""
    case = TPCase(2, 4, "hier_rd", **CASE_C)
    prompt = np.random.default_rng(0).integers(
        0, CASE_C["vocab_size"], (WARM, SLOTS)).astype(np.int32)
    fp_tokens = list(prompt)
    fp = []
    with torch.inference_mode():
        cache = TT.init_cache(case.tap, SLOTS, S_MAX, device="cpu",
                              mesh=case.mesh)
        for t in range(WARM + GREEDY):
            lg, cache = TT.decode_step(
                case.model, cache, torch.tensor(fp_tokens[t]).long(),
                torch.full((SLOTS,), t, dtype=torch.int32), case.tap,
                case.ctx, case.mesh)
            fp.append(lg.numpy())
            if t + 1 >= WARM:
                full = np.moveaxis(lg.numpy(), 0, -2).reshape(SLOTS, -1)
                fp_tokens.append(np.argmax(full[:, :CASE_C["vocab_size"]],
                                           -1).astype(np.int32))
    tokens = np.stack(fp_tokens[:WARM + GREEDY])
    fp = np.stack(fp)
    scale = np.abs(fp).max()
    for quant, rtol in CASE_C_RTOL.items():
        mine = _port_decode(case, quant, tokens)
        want = _jax_decode(case, quant, tokens)
        assert mine.shape == want.shape == fp.shape
        assert np.abs(mine - fp).max() / scale < rtol, quant
        assert np.abs(mine - want).max() / scale < rtol, quant
        assert np.abs(mine - fp).max() > 0                 # it quantized


def test_generate_and_serve_with_ar_quant_on_cpu(capsys):
    """The mesh steps carry a zeroed EF leaf from prefill and every decode
    step refreshes it; the serve CLI runs int8 end to end."""
    case = TPCase(4, 2, "hier_rd")
    ctx = case.ctx.replace(ar_quant="int8")
    prompts = torch.tensor(np.random.default_rng(3).integers(
        0, case.tcfg.vocab_size, (2, 6)))
    prefill = build_prefill(case.tap, ctx, case.mesh, s_max=12)
    step = build_decode_step(case.tap, ctx, case.mesh)
    with torch.inference_mode():
        tok, cache = prefill(case.model, prompts)
        assert cache["ef"].shape == (case.tcfg.n_layers, 2, 8, 2,
                                     case.tcfg.d_model)
        assert not cache["ef"].any()
        for i in range(2):
            tok, cache = step(case.model, cache, tok,
                              torch.full((2,), 6 + i, dtype=torch.int32))
    assert cache["ef"].abs().max() > 0 and tok.shape == (2,)
    res = serve.main(["--arch", "llama3.2-1b", "--mode", "batch",
                      "--device", "cpu", "--tp", "8", "--pods", "4",
                      "--ar-strategy", "hier_rd", "--ar-quant", "int8",
                      "--batch", "2", "--prompt-len", "8", "--max-new", "3"])
    assert res.new_tokens.shape == (2, 3)
    assert "tp=8 (4x2) ar=hier_rd/q=int8" in capsys.readouterr().out
    with pytest.raises(ValueError, match="ar_quant='auto' requires"):
        serve.main(["--device", "cpu", "--tp", "8", "--pods", "4",
                    "--ar-strategy", "hier_rd", "--ar-quant", "auto"])
