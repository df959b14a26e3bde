"""Sequence-parallel prefill of the port held against the JAX package's:
``forward_lm`` with the residual cut on the sequence (``seq_parallel``)
against the JAX ``forward_lm(sp=True)`` under nested ``jax.vmap`` (logits
and the K/V seeds, f32) at 2 x 2 and 4 x 2 under ``flat`` and
``hier_rd``, on the int8 wire, with overlapped projections, at a prompt
the fast axis does not divide, and for the MoE family at one pod (where
the port's EP wiring and the reference's agree); the MoE pod cut (SP on
== off at 2 x 2 and 4 x 2, capacity overflowing); the tuner's SP dispatch
and its table against the JAX tuner's; the recurrent families left
unsharded by the knob; and the engine, the batcher, a disaggregated
deployment and the serve CLI under ``seq_parallel="on"``."""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import autotune as JA  # noqa: E402
from repro.core import comm_model as JCM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import autotune as TA  # noqa: E402
from repro_torch.core import comm_model as TCM  # noqa: E402
from repro_torch.core import hierarchical as TH  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.inference.scheduler import make_trace  # noqa: E402
from repro_torch.inference.spec import (ReplicaSpec, build_engine,  # noqa
                                        build_replica)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from test_torch_quant_collectives import COMPILE  # noqa: E402
from test_torch_tp import TPCase  # noqa: E402

torch.set_num_threads(1)

B, S = 2, 8
# f32: the same sums in another order (the collectives' rank sums
# included), ~1e-6 on O(1) logits
ATOL = 1e-5
MOE = dict(family="moe", n_experts=8, top_k=2, d_ff_expert=32)


def _jctx(case, **knobs):
    jc = case.jctx.replace(**knobs)
    return jc.replace(ep=jc.tp_axes) if case.tcfg.is_moe else jc


def _port(case, tokens, **knobs):
    """The port's forward_lm logits (R, B, S, V_local) and K/V seeds (L,
    R*B, S, u, hd) under ``seq_parallel="on"`` and ``knobs``."""
    ctx = case.ctx.replace(seq_parallel="on", **knobs)
    if case.tcfg.is_moe:
        ctx = ctx.replace(ep=ctx.tp_axes)
    with torch.inference_mode():
        lg, st = TT.forward_lm(case.model, torch.as_tensor(tokens).long(),
                               case.tap, ctx, case.mesh, collect_state=True)
    return lg.numpy(), st["k"].numpy(), st["v"].numpy()


def _jax(case, tokens, **knobs):
    """The JAX forward_lm(sp=True) on every rank, in the port's layouts."""
    ap, ctx = case.jap, _jctx(case, **knobs)

    def fwd(p, t):
        lg, _, st, _ = JT.forward_lm(p, t, ap, ctx, sp=True,
                                     collect_state=True)
        return lg, st["k"], st["v"]

    f = jax.vmap(jax.vmap(fwd, in_axes=(0, None), axis_name="model"),
                 in_axes=(0, None), axis_name="pod")
    tree = jax.tree.map(lambda a: a.reshape(case.pods, case.fast,
                                            *a.shape[1:]), case.local)
    tok = jnp.asarray(tokens)
    out = jax.jit(f).lower(tree, tok).compile(compiler_options=COMPILE)(
        tree, tok)
    R = case.pods * case.fast
    lg, k, v = (np.asarray(a).reshape(R, *a.shape[2:]) for a in out)

    def fold(s):          # (R, L, B, S, u, hd) -> (L, R*B, S, u, hd)
        s = np.moveaxis(s, 0, 1)
        return s.reshape(s.shape[0], R * s.shape[2], *s.shape[3:])
    return lg, fold(k), fold(v)


def _tokens(vocab, s=S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, s)) \
        .astype(np.int32)


def _count_rs(fn):
    """(fn's result, how many tp_reduce_scatter calls it made)."""
    n = [0]
    rs = TH.tp_reduce_scatter

    def counted(*a, **kw):
        n[0] += 1
        return rs(*a, **kw)
    with mock.patch.object(TH, "tp_reduce_scatter", counted):
        out = fn()
    return out, n[0]


@pytest.mark.parametrize("strategy", ["flat", "hier_rd"])
@pytest.mark.parametrize("pods,fast", [(2, 2), (4, 2)],
                         ids=["2x2", "4x2"])
def test_forward_matches_jax(pods, fast, strategy):
    """Logits and K/V seeds of the SP forward == the JAX SP forward; the
    port's SP forward really reduce-scatters (once for the embedding, twice
    a layer)."""
    case = TPCase(pods, fast, strategy)
    tok = _tokens(case.tcfg.vocab_size)
    (lg, k, v), n = _count_rs(lambda: _port(case, tok))
    assert n == 1 + 2 * case.tcfg.n_layers
    want = _jax(case, tok)
    for got, ref in zip((lg, k, v), want):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["int8", "overlap", "indivisible",
                                     "moe_one_pod"])
def test_variants_match_jax(variant):
    """The int8 wire (the same roundings as JAX's: the JAX side is
    compiled without the algebraic simplifier, as the quantized tests
    compile it), overlapped projections (``collective_matmul_reduce_
    scatter``), a prompt the fast axis does not divide (both fall back to
    the fused all-reduce) and the MoE family at one pod (the reference's
    own EP wiring, overflowing capacity)."""
    knobs, s = {}, S
    if variant == "int8":
        case, knobs = TPCase(2, 2, "hier_rd"), dict(ar_quant="int8")
    elif variant == "overlap":
        case = TPCase(2, 2, "hier_rd")
        knobs = dict(overlap_matmul=True, overlap_chunks=2)
    elif variant == "indivisible":
        case, s = TPCase(2, 2, "hier_rd"), S - 1
    else:
        case = TPCase(1, 4, "flat", capacity_factor=1.0, **MOE)
    tok = _tokens(case.tcfg.vocab_size, s)
    mine, n = _count_rs(lambda: _port(case, tok, **knobs))
    per_layer = {"indivisible": 0, "moe_one_pod": 1, "overlap": 2 * 2}
    assert n == (variant != "indivisible") \
        + per_layer.get(variant, 2) * case.tcfg.n_layers
    want = _jax(case, tok, **knobs)
    for got, ref in zip(mine, want):
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if variant == "int8":                  # it did quantize
        assert np.abs(mine[0] - _port(case, tok)[0]).max() > 1e-3


@pytest.mark.parametrize("pods,fast", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
def test_moe_sp_equals_sp_off(pods, fast):
    """Under SP rank (p, f) dispatches chunk p of its fast piece f: the
    same chunks of the sequence, in the same order, as the fused layout
    dispatches, so even with capacity overflowing (capacity factor 1) the
    logits and K/V seeds equal SP off."""
    cfg = dataclasses.replace(get_smoke("qwen3-moe-30b-a3b"),
                              dtype=torch.float32, capacity_factor=1.0)
    mesh, ctx = mesh_and_ctx(pods * fast, pods, ar_strategy="hier_rd",
                             device="cpu")
    ctx = ctx.replace(ep=ctx.tp_axes)
    ap = TT.make_plan(cfg, pods * fast)
    model = TT.init_params(ap, seed=0, device="cpu", mesh=mesh)
    tok = torch.as_tensor(_tokens(cfg.vocab_size, 16)).long()
    with torch.inference_mode():
        off = TT.forward_lm(model, tok, ap, ctx, mesh, collect_state=True)
        on, n = _count_rs(lambda: TT.forward_lm(
            model, tok, ap, ctx.replace(seq_parallel="on"), mesh,
            collect_state=True))
    assert n == 1 + cfg.n_layers
    torch.testing.assert_close(on[0], off[0], atol=ATOL, rtol=0)
    torch.testing.assert_close(on[1]["k"], off[1]["k"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("net", ["perlmutter", "vista", "tpu_v5e"])
def test_sp_dispatch_matches_jax(net, tmp_path):
    """predict_sp_times, choose_sp and the persisted SP table == the JAX
    tuner's over a grid of messages and layouts; a persisted entry
    overrides the analytic seed, and ``seq_parallel="auto"`` consults the
    table at every prefill call."""
    jt, tt = JA.AutoTuner(JCM.NETWORKS[net]), TA.AutoTuner(TCM.NETWORKS[net])
    for fast, slow in ((1, 2), (2, 1), (2, 2), (2, 4), (4, 2), (8, 1)):
        for b in [2 ** p for p in range(8, 30)] + [3000, 5_000_000]:
            assert TA.predict_sp_times(b, fast, slow, tt.net) == \
                JA.predict_sp_times(b, fast, slow, jt.net)
            assert tt.choose_sp(b, fast, slow) == jt.choose_sp(b, fast, slow)
    assert tt.sp_lookup_buckets() == jt.sp_lookup_buckets()
    assert tt.to_json()["sp_table"] == jt.to_json()["sp_table"]
    assert any(tt.sp_table.values()) and not all(tt.sp_table.values())
    # a persisted entry forces SP at a message the model would keep fused
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype=torch.float32)
    mesh, ctx = mesh_and_ctx(4, 2, ar_strategy="hier_rd", device="cpu")
    ap = TT.make_plan(cfg, 4)
    model = TT.init_params(ap, seed=0, device="cpu", mesh=mesh)
    tok = torch.as_tensor(_tokens(cfg.vocab_size)).long()
    msg = B * S * cfg.d_model * 4
    tuner = TA.AutoTuner(TCM.NETWORKS[net])
    assert not tuner.choose_sp(msg, 2, 2, "float32")
    path = tmp_path / "t.json"
    tuner.sp_table[next(iter(tuner.sp_table))] = True
    tuner.save(str(path))
    for t, want in ((TA.AutoTuner(TCM.NETWORKS[net]), 0),
                    (TA.AutoTuner.load(str(path)), 1 + 2 * cfg.n_layers)):
        with TA.using(t), torch.inference_mode():
            _, n = _count_rs(lambda: TT.forward_lm(
                model, tok, ap, ctx.replace(seq_parallel="auto"), mesh))
        assert n == want and t.sp_lookups


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_recurrent_families_stay_unsharded(arch):
    """The knob never cuts a recurrent family's residual (the reference's
    gate); an explicit ``sp=True`` does, with the same logits."""
    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32)
    mesh, ctx = mesh_and_ctx(4, 2, ar_strategy="hier_rd", device="cpu")
    ap = TT.make_plan(cfg, 4)
    model = TT.init_params(ap, seed=0, device="cpu", mesh=mesh)
    tok = torch.as_tensor(_tokens(cfg.vocab_size)).long()
    with torch.inference_mode():
        off = TT.forward_lm(model, tok, ap, ctx, mesh)[0]
        knob, n = _count_rs(lambda: TT.forward_lm(
            model, tok, ap, ctx.replace(seq_parallel="on"), mesh)[0])
        forced, m = _count_rs(lambda: TT.forward_lm(
            model, tok, ap, ctx, mesh, sp=True)[0])
    assert n == 0 and m > 0
    assert torch.equal(knob, off)
    torch.testing.assert_close(forced, off, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def lm4():
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype=torch.float32)
    ap = TT.make_plan(cfg, 4)
    mesh, _ = mesh_and_ctx(4, 2, device="cpu")
    return dict(cfg=cfg, ap=ap,
                model=TT.init_params(ap, seed=0, device="cpu", mesh=mesh))


def _served(lm4, sp, **kw):
    """Every request's tokens through ``build_replica`` (colocated or
    disaggregated) and the count of reduce-scatters it made."""
    spec = ReplicaSpec(arch="llama3.2-1b", slots=3, s_max=64,
                       ar_strategy="hier_rd", seq_parallel=sp, **kw)
    reqs = make_trace(6, mean_in=10, mean_out=5, rate=3.0,
                      vocab=lm4["cfg"].vocab_size, seed=4)
    for r in reqs:          # even prompts, so that the fast axis divides
        r.prompt = r.prompt[:len(r.prompt) // 2 * 2]
    rep = build_replica(spec, ap=lm4["ap"], model=lm4["model"],
                        device="cpu")
    done, n = _count_rs(lambda: rep.run(reqs))
    return {r.rid: r.output for r in done}, n


@pytest.mark.parametrize("kind", ["batcher", "disagg"])
def test_serving_under_sp_gives_the_same_tokens(lm4, kind):
    """The batcher's full admission and a disaggregated prefill pool
    prefill under SP (reduce-scatters counted) and give the tokens of
    ``seq_parallel="off"`` (bitwise sums under hier_rd); the decode pool
    is built with SP off."""
    kw = dict(tp=4, pods=2) if kind == "batcher" else dict(
        disagg=True, prefill_tp=4, prefill_pods=2, decode_tp=4,
        decode_pods=2, block_size=8, prefill_block_size=0)
    off, n_off = _served(lm4, "off", **kw)
    on, n_on = _served(lm4, "on", **kw)
    assert n_off == 0 and n_on > 0
    assert on.keys() == off.keys()
    assert all(np.array_equal(on[r], off[r]) for r in off)
    if kind == "disagg":
        rep = build_replica(ReplicaSpec(arch="llama3.2-1b", seq_parallel="on",
                                        **kw), ap=lm4["ap"],
                            model=lm4["model"], device="cpu")
        assert rep.prefill.ctx.seq_parallel == "on"
        assert rep.decode.ctx.seq_parallel == "off"


def test_engine_and_serve_cli_under_sp(lm4, capsys):
    """``generate`` under SP on / auto equals SP off; ``serve
    --seq-parallel on`` runs on the CPU and says so."""
    spec = ReplicaSpec(arch="llama3.2-1b", tp=4, pods=2, s_max=32,
                       ar_strategy="hier_rd")
    prompts = _tokens(lm4["cfg"].vocab_size)
    toks = {}
    for sp in ("off", "on", "auto"):
        eng = build_engine(spec.replace(seq_parallel=sp), ap=lm4["ap"],
                           model=lm4["model"], device="cpu")
        assert eng.ctx.seq_parallel == sp
        toks[sp] = eng.generate(prompts, 4).tokens
    assert np.array_equal(toks["on"], toks["off"])
    assert np.array_equal(toks["auto"], toks["off"])
    serve.main(["--arch", "llama3.2-1b", "--mode", "batch", "--device",
                "cpu", "--tp", "4", "--pods", "2", "--ar-strategy",
                "hier_rd", "--seq-parallel", "on", "--batch", "2",
                "--prompt-len", "8", "--max-new", "3"])
    assert "sp=on" in capsys.readouterr().out
