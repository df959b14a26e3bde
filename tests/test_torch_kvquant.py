"""The port's int8 KV cache (``kv_quant``) held against the JAX package:
the quantizing splice of ``seed_cache`` and the decode write bitwise the
reference's on the same K/V, kernel 1's int8 form's plain version against
the reference's dequantization, the decode path's logits at tp=1 and at
tp=4 through the virtual mesh, the batcher's row operations (admission,
preemption, the quarantine scrub, the NaN poke into ``k_scale``) and the
reference's refusals.  Smoke sizes, f32.

The harness here (:func:`run_jax`, :func:`run_port`) is shared with
``test_torch_wquant.py`` and ``test_torch_window_cache.py``: a prompt is
prefilled, then a fixed token sequence is fed one decode step at a time
(teacher-forced), so both packages see the same inputs at every step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.pcontext import LOCAL as JLOCAL  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel import quant as JQ  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.core.pcontext import LOCAL  # noqa: E402
from repro_torch.inference.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.inference.scheduler import ContinuousBatcher  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref)
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.parallel.quant import LayerMap, quantize_model  # noqa: E402

torch.set_num_threads(1)

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# A dense config whose tp=4 plan is its tp=1 layout (8 q heads and 4 kv
# heads, one kv head a rank, vocab 96 = 4 x 24): the JAX tp=1 tree is the
# global tree the mesh cuts, so tp=4 logits compare with JAX's local run.
TINY = dict(family="dense", n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
            head_dim=16, d_ff=128, vocab_size=96)
B, S, NEW = 2, 6, 5
# f32 logits of the int8 cache: both sides quantize the same K/V to the
# same int8 steps (an element an ulp apart across a rounding tie of its
# step would flip one, which these inputs do not meet), so the gap is the
# f32 summation order: 2e-6 measured.  The int8 rounding itself moves the
# logits by 3.4e-2 against the f32 cache, so a wrong scale or payload
# cannot pass.
KV8_TOL = 1e-4


def tiny_cfgs(**kw):
    base = dict(TINY, **kw)
    return (JC.ModelConfig(name="tiny", dtype=jnp.float32, **base),
            TC.ModelConfig(name="tiny", dtype=torch.float32, **base))


def jax_tree(jcfg):
    """The JAX ``init_params`` tree at tp=1 as numpy arrays."""
    jap = JT.make_plan(jcfg, 1)
    key = jax.random.PRNGKey(0)
    jp = jax.jit(lambda k: JT.init_params(k, jap)).lower(key).compile(
        compiler_options=FAST_COMPILE)(key)
    return jax.tree.map(np.asarray, jp)


def inputs(vocab, seed=3, b=B, s=S, new=NEW):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, s)).astype(np.int32),
            rng.integers(0, vocab, (b, new)).astype(np.int32))


def run_jax(jcfg, tree, prompts, forced, s_max, *, kv_quant=False,
            window_cache=False, weight_quant=False):
    """The reference at tp=1: the prefill's last logits, then each
    teacher-forced decode step's, (B, 1 + n, V); and the final cache."""
    jap = JT.make_plan(jcfg, 1)
    params = jax.tree.map(jnp.asarray, tree)
    dparams = JQ.quantize_params(params) if weight_quant else params
    b, s = prompts.shape

    def prefill(p, tok):
        lg, _, st, _ = JT.forward_lm(p, tok, jap, JLOCAL, collect_state=True)
        return lg[:, -1], JT.seed_cache(JT.init_cache(
            jap, b, s_max, kv_quant=kv_quant, window_cache=window_cache), st)

    def decode(p, cache, t, pos):
        return JT.decode_step(
            p, cache, t, pos, jap, JLOCAL, kv_ring=window_cache,
            layer_map=JQ.dequant_layer if weight_quant else None)

    lg, cache = jax.jit(prefill).lower(params, jnp.asarray(prompts)) \
        .compile(compiler_options=FAST_COMPILE)(params, jnp.asarray(prompts))
    pos = jnp.full((b,), s, jnp.int32)
    step = jax.jit(decode).lower(dparams, cache, jnp.asarray(forced[:, 0]),
                                 pos).compile(compiler_options=FAST_COMPILE)
    out = [np.asarray(lg, np.float32)]
    for i in range(forced.shape[1]):
        ld, cache = step(dparams, cache, jnp.asarray(forced[:, i]), pos + i)
        out.append(np.asarray(ld, np.float32))
    return np.stack(out, 1), jax.tree.map(np.asarray, cache)


def port_model(tcfg, tree, tp=1, pods=1, strategy="hier_rd"):
    """(ap, model, ctx, mesh) of the bridged tree at tp (a virtual mesh of
    ``pods`` x tp/pods ranks past 1)."""
    mesh, ctx = (None, LOCAL) if tp == 1 else mesh_and_ctx(
        tp, pods, ar_strategy=strategy, device="cpu")
    ap = TT.make_plan(tcfg, tp)
    return ap, params_from_numpy(tree, tcfg, "cpu", mesh=mesh), ctx, mesh


def run_port(ap, model, ctx, mesh, prompts, forced, s_max, *,
             kv_quant=False, window_cache=False, weight_quant=False):
    """The port's counterpart of :func:`run_jax`: logits gathered to the
    full (padded) vocab, (B, 1 + n, V_pad), and the cache."""
    b, s = prompts.shape
    lm = LayerMap(TT.w8_keep(ctx), ap.cfg.dtype) if weight_quant else None
    dmodel = quantize_model(model) if weight_quant else model

    def full(lg):
        return (lg if mesh is None else lg.permute(1, 0, 2).reshape(b, -1)) \
            .float().numpy()

    with torch.inference_mode():
        lg, st = TT.forward_lm(model, torch.tensor(prompts).long(), ap, ctx,
                               mesh, collect_state=True)
        last = lg[..., -1, :]
        cache = TT.seed_cache(TT.init_cache(
            ap, b, s_max, device="cpu", mesh=mesh, kv_quant=kv_quant,
            window_cache=window_cache), st)
        out = [full(last)]
        for i in range(forced.shape[1]):
            ld, cache = TT.decode_step(
                dmodel, cache, torch.tensor(forced[:, i]).long(),
                torch.full((b,), s + i, dtype=torch.int32), ap, ctx, mesh,
                layer_map=lm, kv_ring=window_cache)
            out.append(full(ld))
    return np.stack(out, 1), cache


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = tiny_cfgs()
    return dict(jcfg=jcfg, tcfg=tcfg, tree=jax_tree(jcfg))


def test_kv8_logits_match_jax_at_tp1_and_tp4(tiny):
    """int8-KV logits at tp=1 and tp=4 (2 x 2, hier_rd) against the JAX
    decode on the same weights and inputs, within KV8_TOL; tp=4 against
    tp=1 in the port likewise (each rank quantizes its own kv head, the
    same rows as tp=1's)."""
    prompts, forced = inputs(TINY["vocab_size"])
    s_max = S + NEW + 1
    want, _ = run_jax(tiny["jcfg"], tiny["tree"], prompts, forced, s_max,
                      kv_quant=True)
    got = {}
    for tp, pods in ((1, 1), (4, 2)):
        run = port_model(tiny["tcfg"], tiny["tree"], tp, pods)
        got[tp], cache = run_port(*run, prompts, forced, s_max,
                                  kv_quant=True)
        assert cache["k"].dtype == torch.int8 \
            and cache["k_scale"].dtype == torch.bfloat16
        v = TINY["vocab_size"]
        np.testing.assert_allclose(got[tp][..., :v], want, atol=KV8_TOL,
                                   rtol=0)
    np.testing.assert_allclose(got[4], got[1], atol=KV8_TOL, rtol=0)


def test_seed_cache_and_decode_writes_are_bitwise_the_reference(tiny):
    """The quantizing splice and four decode writes of the same K/V give
    the reference's int8 payloads and bf16 scales bit for bit.  The
    projections are exact one-hot selections (d_model = U * hd, rope off),
    so both packages write the same K/V at every step."""
    jcfg, tcfg = tiny_cfgs(d_model=64, rope_theta=0.0)
    jap, tap = JT.make_plan(jcfg, 1), TT.make_plan(tcfg, 1)
    rng = np.random.default_rng(5)
    D, U, hd, s_max, n0 = 64, 4, 16, 12, 5
    eye = np.eye(D, dtype=np.float32).reshape(D, U, hd)
    p = {"wq": np.tile(eye, (1, 2, 1)), "wk": eye, "wv": eye[:, ::-1].copy()}
    states = {n: rng.standard_normal((2, B, n0, U, hd)).astype(np.float32)
              * 3 for n in ("k", "v")}
    jc = JT.seed_cache(JT.init_cache(jap, B, s_max, kv_quant=True),
                       jax.tree.map(jnp.asarray, states))
    tc_ = TT.seed_cache(TT.init_cache(tap, B, s_max, device="cpu",
                                      kv_quant=True),
                        {n: torch.tensor(a) for n, a in states.items()})
    jc = {n: jc[n][0] for n in ("k", "v", "k_scale", "v_scale")}
    tc_ = {n: tc_[n][0].clone() for n in ("k", "v", "k_scale", "v_scale")}
    def jstep(pj, h, c, pos):
        return JL.attention_decode(pj, h, c, jcfg, jap.gqa, JLOCAL,
                                   positions=pos, project=False)[1]
    pj = jax.tree.map(jnp.asarray, p)
    h0, pos0 = jnp.zeros((B, 1, D)), jnp.zeros((B,), jnp.int32)
    jstep = jax.jit(jstep).lower(pj, h0, jc, pos0).compile(
        compiler_options=FAST_COMPILE)
    for i in range(4):
        h = rng.standard_normal((B, 1, D)).astype(np.float32) * (i + 1)
        pos = np.full((B,), n0 + i, np.int32)
        jc = jstep(pj, jnp.asarray(h), jc, jnp.asarray(pos))
        TL.attention_decode({k: torch.tensor(a)[None] for k, a in p.items()},
                            torch.tensor(h)[None], tc_, tcfg,
                            positions=torch.tensor(pos),
                            kv_positions=torch.tensor(pos))
    for n in ("k", "v", "k_scale", "v_scale"):
        want = np.asarray(jc[n])
        got = tc_[n].float().numpy() if n.endswith("scale") \
            else tc_[n].numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=n)
    assert np.count_nonzero(np.asarray(jc["k"])[:, n0 + 3]) > 0


@pytest.mark.parametrize("g,window", [(1, 0), (4, 0), (4, 5)])
def test_int8_plain_version_is_the_dequantized_plain_version(g, window):
    """Kernel 1's int8 form on the CPU: the cache dequantized as the
    reference's ``attn_core`` (``q.dtype(float(k) * float(scale))``), then
    the plain version; in bf16 the dequantized operand is bf16-rounded."""
    rng = np.random.default_rng(g)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.tensor(rng.standard_normal((3, 2 * g, 16)),
                         dtype=torch.float32).to(dt)
        k8, v8 = (torch.tensor(rng.integers(-127, 128, (3, 20, 2, 16)),
                               dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.tensor(rng.random((3, 20, 2)) / 40,
                               dtype=torch.float32).bfloat16()
                  for _ in range(2))
        pos = torch.tensor([0, 7, 19], dtype=torch.int32)
        got = decode_attention(q, k8, v8, pos, window=window, k_scale=ks,
                               v_scale=vs)
        kd = (k8.float() * ks.float()[..., None]).to(dt)
        vd = (v8.float() * vs.float()[..., None]).to(dt)
        assert torch.equal(got, decode_attention_ref(q, kd, vd, pos,
                                                     window=window))


@pytest.fixture(scope="module")
def llama_tiny(tiny):
    ap, model, _, _ = port_model(tiny["tcfg"], tiny["tree"])
    return ap, model


def _trace(n=6):
    rng = np.random.default_rng(11)
    return [(rng.integers(0, TINY["vocab_size"], int(rng.integers(3, 9)))
             .astype(np.int32), int(rng.integers(3, 8))) for _ in range(n)]


def _serve(ap, model, injector=None, slots=3):
    from repro_torch.inference.scheduler import Request
    b = ContinuousBatcher(ap, model, slots=slots, s_max=24, kv_quant=True,
                          injector=injector, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=m, arrival_s=float(i // 2))
            for i, (p, m) in enumerate(_trace())]
    b.run(reqs)
    return b, {r.rid: r.output for r in reqs}


def test_batcher_kv8_survivors_equal_the_fault_free_run(llama_tiny):
    """The batcher over the int8 cache: every request completes, and
    under NaN pokes (into the slot's ``k_scale``), OOM preemptions and
    the quarantine scrub of the scale rows every request's tokens equal
    the fault-free run's (recompute replays the request exactly); the
    pokes reach the finite guard."""
    ap, model = llama_tiny
    base, want = _serve(ap, model)
    assert base.cache["k"].dtype == torch.int8
    assert all(o is not None and len(o) for o in want.values())
    plan = FaultPlan.parse("seed=7,nan_logits=0.3,oom=0.2")
    b, got = _serve(ap, model, injector=FaultInjector(plan))
    assert b._quarantines > 0 and b._preemptions > 0
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks)


def test_poke_writes_nan_into_the_slots_k_scale(llama_tiny):
    """The port's poke on the int8 cache: NaN into ``k_scale`` at the
    slot's last written position (the reference's ``jnp.asarray(nan,
    int8)`` raises ``ValueError``), which the scrub zeroes."""
    ap, model = llama_tiny
    b = ContinuousBatcher(ap, model, slots=2, s_max=16, kv_quant=True,
                          device="cpu")
    b.positions[1] = 5
    b._poison_slot(1)
    ks = b.cache["k_scale"]
    assert torch.isnan(ks[:, 1, 4]).all() and not torch.isnan(ks[:, 0]).any()
    assert b.cache["k"].dtype == torch.int8
    b._scrub_slot(1)
    assert not torch.isnan(ks).any() and not ks[:, 1].any()
    with pytest.raises(ValueError, match="convert float NaN to integer"):
        jnp.asarray(jnp.nan, jnp.int8)


@pytest.mark.parametrize("knob,match", [
    (dict(block_size=8), "paged"),
    (dict(admit_mode="chunked", admit_chunk=8), "full-prefill admission"),
    (dict(spec_mode="ngram"), "speculative decoding"),
    (dict(prefix_cache="on", block_size=8, admit_chunk=8),
     "prefix_cache is incompatible with kv_quant"),
], ids=["paged", "chunked", "spec", "prefix"])
def test_batcher_refuses_what_the_reference_refuses(llama_tiny, knob, match):
    ap, model = llama_tiny
    with pytest.raises(ValueError, match=match):
        ContinuousBatcher(ap, model, s_max=32, kv_quant=True, device="cpu",
                          **knob)


def test_cache_layouts_and_chunked_prefill_refusal(llama_tiny):
    ap, model = llama_tiny
    with pytest.raises(ValueError, match="incompatible with kv_quant"):
        TT.init_cache(ap, 2, 16, block_size=8, device="cpu", kv_quant=True)
    c = TT.init_cache(ap, 2, 16, device="cpu", kv_quant=True)
    assert c["k_scale"].shape == (2, 2, 16, 4) and c["k"].dtype == torch.int8
    with pytest.raises(NotImplementedError,
                       match="chunked prefill with kv_quant"):
        TT.prefill_chunk(model, c, torch.zeros((2, 4), dtype=torch.long),
                         torch.zeros((2, 4), dtype=torch.int32), ap)
