"""The port's MoE family (``repro_torch/models/moe.py`` and the MoE branches
of the model, sharding, bridge, engine and serve CLI) and the plain
version of its grouped expert FFN kernel, held against the JAX package on
the same inputs, made with numpy from a seed: the kernel's oracle
(``repro/kernels/moe_gemm``), the router, the capacity dispatch (with
overflow) and the dense decode path at tp=1 and, under nested
``jax.vmap`` with ``ep`` = the TP axes, over the virtual mesh; then the
whole smoke model (forward and decode logits, tp=8 == tp=1 == JAX local
tokens, paged == dense).

Each JAX function is traced once and compiled without XLA's backend
optimisations (several times faster on one core)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.pcontext import ParallelCtx as JCtx  # noqa: E402
from repro.kernels.moe_gemm import (moe_expert_ffn as pallas_ffn,  # noqa: E402
                                    moe_expert_ffn_ref as jax_ffn_ref)
from repro.models import common as JC  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.core.pcontext import LOCAL  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.kernels import moe_expert_ffn  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402

torch.set_num_threads(1)

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# tests/test_kernels.py's cases (E, C, D, F, dtype) and tolerances
MOE_CASES = [(4, 128, 64, 128, "float32"), (2, 100, 128, 200, "float32"),
             (8, 256, 64, 96, "bfloat16")]
KTOL = {"float32": 1e-5, "bfloat16": 3e-2}
# tests/dist_cases/case_decode_parity.py's tiny MoE config, f32
TINY = dict(family="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=96, n_experts=8, top_k=2,
            d_ff_expert=32, capacity_factor=8.0)
B, S = 4, 8
# f32 layer outputs and logits: the same math in another summation order
ATOL_LAYER, ATOL_AUX, ATOL_LOGITS = 1e-5, 1e-6, 1e-4


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def _cfgs(**kw):
    base = dict(TINY, **kw)
    return (JC.ModelConfig(name="tiny-moe", dtype=jnp.float32, **base),
            TC.ModelConfig(name="tiny-moe", dtype=torch.float32, **base))


def _moe_params(cfg, seed=0):
    """A MoE group in the global layout of the JAX ``init_moe`` (router
    (D, E), wg/wu (E, D, F), wd (E, F, D)), Normal(0, 1/fan_in), numpy."""
    rng = np.random.default_rng(seed)
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert

    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)) \
            .astype(np.float32)
    return {"router": w((d, e), d), "wg": w((e, d, fe), d),
            "wu": w((e, d, fe), d), "wd": w((e, fe, d), fe)}


def _port_moe(p, mesh=None):
    """The global leaves cut over the mesh's ranks as the port's sharding
    cuts a ``moe`` group: router replicated, experts on their axis."""
    return TS.shard_params({"moe": {k: torch.tensor(v) for k, v in
                                    p.items()}}, mesh)["moe"]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# Kernel 7's plain version
# ---------------------------------------------------------------------------


def _ffn_operands(E, C, D, F, seed, G=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G or E, C, D)),
            rng.standard_normal((E, D, F)) * 0.05,
            rng.standard_normal((E, D, F)) * 0.05,
            rng.standard_normal((E, F, D)) * 0.05)


@pytest.mark.parametrize("case", MOE_CASES,
                         ids=[f"case{i}" for i in range(len(MOE_CASES))])
def test_expert_ffn_plain_matches_jax_oracle(case):
    E, C, D, F, dt = case
    ops = _ffn_operands(E, C, D, F, seed=E + C)
    want = np.asarray(jax_ffn_ref(*(jnp.asarray(a, dt) for a in ops)),
                      np.float32)
    got = moe_expert_ffn(*(torch.tensor(a, dtype=torch.float32).to(
        getattr(torch, dt)) for a in ops))
    assert got.dtype == getattr(torch, dt) and got.shape == (E, C, D)
    np.testing.assert_allclose(got.float().numpy(), want, atol=KTOL[dt],
                               rtol=KTOL[dt])


def test_expert_ffn_plain_matches_pallas_interpret():
    """One case against the TPU kernel itself, run in interpret mode
    (C and F padded by its wrapper to the 128 tiles)."""
    ops = _ffn_operands(2, 100, 128, 200, seed=7)
    want = np.asarray(pallas_ffn(*(jnp.asarray(a, jnp.float32) for a in ops),
                                 interpret=True))
    got = moe_expert_ffn(*(torch.tensor(a, dtype=torch.float32)
                           for a in ops))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_expert_ffn_shared_token_blocks():
    """x (G, C, D) with G < E: expert e reads block e // (E / G), the
    decode path's operand; equal to the oracle on the repeated blocks."""
    x, wg, wu, wd = _ffn_operands(8, 5, 32, 24, seed=3, G=2)
    want = np.asarray(jax_ffn_ref(jnp.asarray(np.repeat(x, 4, axis=0),
                                              jnp.float32),
                                  *(jnp.asarray(a, jnp.float32)
                                    for a in (wg, wu, wd))))
    got = moe_expert_ffn(*(torch.tensor(a, dtype=torch.float32)
                           for a in (x, wg, wu, wd)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_expert_ffn_wrapper_checks_and_never_falls_back():
    """Bad shapes raise; a tensor that is not on the CPU never reaches the
    plain version (here a 'meta' tensor: neither CPU nor CUDA), and
    nothing launches."""
    x, wg, wu, wd = (torch.tensor(a, dtype=torch.float32)
                     for a in _ffn_operands(4, 3, 16, 8, seed=1))
    before = moe_expert_ffn.launches
    with pytest.raises(ValueError, match="expert groups"):
        moe_expert_ffn(x[:3], wg, wu, wd)
    with pytest.raises(ValueError, match="D, F"):
        moe_expert_ffn(x, wg, wu, wd.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        moe_expert_ffn(x.to("meta"), wg.to("meta"), wu.to("meta"),
                       wd.to("meta"))
    moe_expert_ffn(x, wg, wu, wd)
    assert moe_expert_ffn.launches == before


@pytest.mark.parametrize("D,esz,dt", [
    (2048, 2, 2048), (2048, 4, 2048),     # qwen3-moe: one launch
    (4458, 2, 4458), (4459, 2, 4459),     # bf16: D tiled inside the CTA
    (3344, 4, 3344), (3345, 4, 2048),     # the f32 limit
    (6144, 2, 6144), (6144, 4, 2048),     # dbrx-132b: D tiled in f32
])
def test_expert_ffn_d_tiling(D, esz, dt):
    """Kernel 7's f32 form keeps its one-launch design while the (8, D)
    f32 accumulator and token rows fit one CTA's shared memory (227 KB),
    and tiles D by 2048 columns past it, whatever D; the bf16 form tiles D
    inside the CTA (256 columns a down pass), so one CTA's output spans
    all of D at any d_model and its shared memory does not grow with D."""
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    assert moe_ops.d_tile(D, esz) == dt
    assert (moe_ops.smem_bytes(D, esz) <= moe_ops.MAX_SMEM) == (dt == D)
    assert moe_ops.smem_bytes(2048, 4) == 149504      # 146 KB (PERF.md)
    assert moe_ops.smem_bytes(D, 2) == 96384          # 94 KB, any D


def test_expert_ffn_wrapper_takes_any_d():
    """No d_model is refused (the wrapper raised past 227 KB a CTA)."""
    from repro_torch.kernels.moe_gemm import moe_expert_ffn_ref
    x, wg, wu, wd = (torch.tensor(a, dtype=torch.float32)
                     for a in _ffn_operands(2, 3, 6144, 8, seed=2))
    assert torch.equal(moe_expert_ffn(x, wg, wu, wd),
                       moe_expert_ffn_ref(x, wg, wu, wd))


# ---------------------------------------------------------------------------
# The MoE layer at tp=1
# ---------------------------------------------------------------------------


def test_router_matches_jax():
    jcfg, tcfg = _cfgs()
    p = _moe_params(jcfg)
    x = _x((B * S, jcfg.d_model), seed=1)
    jg, ji, jp = JM._router({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jcfg)
    tg, ti, tp = TM._router(_port_moe(p), torch.tensor(x)[None], tcfg)
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp), atol=1e-6)


def _jax_layer(jcfg, p, x):
    """The reference's dispatch (out, aux) and dense outputs at tp=1."""
    def run(p, x):
        out, aux = JM.moe_ffn_dispatch(p, x, jcfg, JCtx())
        return out, aux, JM.moe_ffn_dense(p, x, jcfg, JCtx())
    return [np.asarray(a) for a in _jit(run, {k: jnp.asarray(v) for k, v in
                                              p.items()}, jnp.asarray(x))]


@pytest.mark.parametrize("cf", [8.0, 1.25], ids=["no-drop", "cf1.25"])
def test_dispatch_and_dense_match_jax(cf):
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    p = _moe_params(jcfg)
    x = _x((B, S, jcfg.d_model), seed=2)
    want_out, want_aux, want_dense = _jax_layer(jcfg, p, x)
    tp, tx = _port_moe(p), torch.tensor(x)[None]
    out, aux = TM.moe_ffn(tp, tx, tcfg, LOCAL, decode=False)
    np.testing.assert_allclose(out[0].numpy(), want_out, atol=ATOL_LAYER,
                               rtol=ATOL_LAYER)
    np.testing.assert_allclose(aux[0].item(), float(want_aux),
                               atol=ATOL_AUX)
    dense, none = TM.moe_ffn(tp, tx, tcfg, LOCAL, decode=True)
    assert none is None
    np.testing.assert_allclose(dense[0].numpy(), want_dense,
                               atol=ATOL_LAYER, rtol=ATOL_LAYER)


def test_overflow_keeps_the_reference_pairs(monkeypatch):
    """capacity_factor 1.0: pairs overflow.  With every expert the
    identity, a token's output is x times the sum of its kept gates, which
    names the kept subset of its K = 2 pairs; that subset must be the
    reference's for every token."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    p = _moe_params(jcfg)
    x = _x((B, S, jcfg.d_model), seed=4)
    monkeypatch.setattr(JM, "_expert_ffn", lambda p, buf: buf)
    monkeypatch.setattr(TM, "_expert_ffn", lambda p, buf: buf)
    jout, _ = JM.moe_ffn_dispatch({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), jcfg, JCtx())
    tout, _ = TM.moe_ffn_dispatch(_port_moe(p), torch.tensor(x)[None], tcfg,
                                  LOCAL)
    gates = TM._router(_port_moe(p), torch.tensor(x).reshape(1, B * S, -1),
                       tcfg)[0][0].numpy()
    x2 = x.reshape(B * S, -1)
    subsets = np.array([[a, b] for a in (0, 1) for b in (0, 1)])
    kept = []
    for out in (np.asarray(jout), tout[0].numpy()):
        s = (out.reshape(B * S, -1) * x2).sum(-1) / (x2 * x2).sum(-1)
        sums = gates @ subsets.T                       # (T, 4)
        pick = np.abs(sums - s[:, None]).argmin(-1)
        np.testing.assert_allclose(sums[np.arange(B * S), pick], s,
                                   atol=1e-5)
        kept.append(subsets[pick])
    np.testing.assert_array_equal(kept[1], kept[0])
    assert 0 < kept[0].sum() < B * S * 2              # some kept, some not


def test_dispatch_is_deterministic():
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    tp = _port_moe(_moe_params(jcfg))
    x = torch.tensor(_x((1, B, S, jcfg.d_model), seed=5))
    a, _ = TM.moe_ffn_dispatch(tp, x, tcfg, LOCAL)
    b, _ = TM.moe_ffn_dispatch(tp, x, tcfg, LOCAL)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The MoE layer on the virtual mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_moe_layer_on_mesh_matches_jax(layout):
    """Dispatch (each rank its own tokens, EP all-to-all) and dense
    (replicated tokens, TP-partial outputs) against the reference under
    nested vmap with ep = the TP axes."""
    pods, fast = layout
    R = pods * fast
    jcfg, tcfg = _cfgs()
    mesh, ctx = mesh_and_ctx(R, pods, device="cpu")
    jctx = JCtx(tp_fast=ctx.tp_fast, tp_slow=ctx.tp_slow, ep=ctx.ep)
    assert ctx.ep == ctx.tp_axes
    p = _moe_params(jcfg)
    local = {k: np.stack([v] * R) if k == "router"
             else v.reshape(R, -1, *v.shape[1:]) for k, v in p.items()}
    xd = _x((R, B, S, jcfg.d_model), seed=6)
    xr = _x((B, S, jcfg.d_model), seed=7)

    def run(p, xd, xr):
        return (JM.moe_ffn_dispatch(p, xd, jcfg, jctx)[0],
                JM.moe_ffn_dense(p, xr, jcfg, jctx))

    f = jax.vmap(jax.vmap(run, in_axes=(0, 0, None), axis_name="model"),
                 in_axes=(0, 0, None), axis_name="pod")
    tree = {k: jnp.asarray(v.reshape(pods, fast, *v.shape[1:]))
            for k, v in local.items()}
    want = [np.asarray(a).reshape(R, *a.shape[2:]) for a in
            _jit(f, tree, jnp.asarray(xd.reshape(pods, fast, B, S, -1)),
                 jnp.asarray(xr))]
    tp = _port_moe(p, mesh)
    for k, v in local.items():
        np.testing.assert_array_equal(tp[k].numpy(), v)
    out, _ = TM.moe_ffn_dispatch(tp, torch.tensor(xd), tcfg, ctx, mesh)
    dense = TM.moe_ffn_dense(tp, torch.tensor(xr).expand(R, B, S, -1),
                             tcfg, ctx, mesh)
    np.testing.assert_allclose(out.numpy(), want[0], atol=ATOL_LAYER,
                               rtol=ATOL_LAYER)
    np.testing.assert_allclose(dense.numpy(), want[1], atol=ATOL_LAYER,
                               rtol=ATOL_LAYER)


def test_mesh_refuses_ep_narrower_than_tp():
    """The reference's cross-pod wiring ep=("model",) with pods cuts the
    experts over both axes but offsets them over one (ROADMAP §3): the
    mesh refuses it, and an empty ep on a mesh is refused by the layer."""
    mesh, ctx = mesh_and_ctx(8, 4, ar_strategy="hier_rd", device="cpu")
    assert ctx.ep == ("pod", "model")
    mesh.check_ctx(ctx)
    with pytest.raises(ValueError, match="ep=\\('model',\\)"):
        mesh.check_ctx(ctx.replace(ep=("model",)))
    jcfg, tcfg = _cfgs()
    tp = _port_moe(_moe_params(jcfg), mesh)
    x = torch.zeros((8, 1, 8, tcfg.d_model))
    with pytest.raises(ValueError, match="needs ep"):
        TM.moe_ffn_dense(tp, x, tcfg, ctx.replace(ep=()), mesh)


def test_sharding_and_plan_of_the_moe_family():
    jcfg, tcfg = _cfgs()
    assert TS.tp_dim(("moe", "wg"), 3) == 0
    assert TS.tp_dim(("mlp", "wg"), 2) == 1
    assert TS.tp_dim(("moe", "router"), 2) is None
    ap = TT.make_plan(tcfg, 8)
    assert ap.tp == 8 and ap.vocab_pad == 96
    with pytest.raises(ValueError, match="n_experts=8 not divisible by "
                                         "tp=16"):
        TT.make_plan(tcfg, 16)
    for arch in ("qwen3-moe-30b-a3b", "dbrx-132b"):
        for get, jget in ((get_config, None), (get_smoke, jax_smoke)):
            cfg = get(arch)
            assert cfg.is_moe and cfg.family == "moe"
            if jget is not None:
                jc = jget(arch)
                assert (cfg.param_count(), cfg.active_param_count()) == \
                    (jc.param_count(), jc.active_param_count())
    full = get_config("qwen3-moe-30b-a3b")
    assert 25e9 < full.param_count() < 34e9
    assert (full.n_layers, full.d_model, full.n_experts, full.top_k,
            full.d_ff_expert, full.head_dim) == (48, 2048, 128, 8, 768, 128)


# ---------------------------------------------------------------------------
# The whole model: qwen3-moe smoke config, f32
# ---------------------------------------------------------------------------

# capacity_factor E/K: no pair overflows at any tp, so tp=8 (each rank its
# own capacity) computes the function tp=1 computes
NO_DROP = 4.0
MB, MS, NEW = 2, 8, 4


def _smoke_cfgs():
    jc = dataclasses.replace(jax_smoke("qwen3-moe-30b-a3b"),
                             dtype=jnp.float32, capacity_factor=NO_DROP)
    tc = dataclasses.replace(get_smoke("qwen3-moe-30b-a3b"),
                             dtype=torch.float32, capacity_factor=NO_DROP)
    return jc, tc


def _to_tp(tree, cfg, tp):
    """A tp=1 parameter tree re-laid for the plan at ``tp``: each
    attention head moved from its tp=1 slot into its slot of the tp plan
    (dead slots zero) and the vocab zero-padded to the tp's padding, so
    the two trees compute one function (the JAX ``init_params`` at tp
    would draw the embedding at the other padding, another function)."""
    one, many = (TC.plan_gqa(cfg.n_heads, cfg.n_kv_heads, t) for t in (1, tp))

    def move(a, axis, m1, mn):
        heads = np.take(a, [list(m1).index(h) for h in range(max(m1) + 1)],
                        axis=axis)
        m = np.asarray(mn)
        live = (m >= 0).reshape([-1 if i == axis else 1
                                 for i in range(a.ndim)])
        return np.where(live, np.take(heads, np.maximum(m, 0), axis=axis),
                        0).astype(a.dtype)

    attn = tree["blocks"]["attn"]
    out = {**tree, "blocks": {**tree["blocks"], "attn": {
        "wq": move(attn["wq"], 2, one.q_map, many.q_map),
        "wk": move(attn["wk"], 2, one.kv_map, many.kv_map),
        "wv": move(attn["wv"], 2, one.kv_map, many.kv_map),
        "wo": move(attn["wo"], 1, one.q_map, many.q_map)}}}
    pad = TC.pad_to(cfg.vocab_size, tp) - tree["embed"]["tok"].shape[0]
    out["embed"] = {"tok": np.pad(tree["embed"]["tok"], ((0, pad), (0, 0))),
                    "head": np.pad(tree["embed"]["head"], ((0, 0), (0, pad)))}
    return out


@pytest.fixture(scope="module")
def smoke():
    """The JAX ``init_params`` tree at tp=1 and its tp=8 re-layout (one
    function), prompts, and the reference's greedy run at tp=1: prefill
    logits, each decode step's logits, the tokens."""
    jcfg, tcfg = _smoke_cfgs()
    s_max = MS + NEW
    jap = JT.make_plan(jcfg, 1)
    key = jax.random.PRNGKey(0)
    jp = jax.jit(lambda k: JT.init_params(k, jap)).lower(key).compile(
        compiler_options=FAST_COMPILE)(key)
    p1 = jax.tree.map(np.asarray, jp)
    p8 = _to_tp(p1, tcfg, 8)
    prompts = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (MB, MS)).astype(np.int32)

    def prefill(p, tok):
        lg, _, st, _ = JT.forward_lm(p, tok, jap, JCtx(), collect_state=True)
        return lg, JT.seed_cache(JT.init_cache(jap, MB, s_max), st)

    def decode(p, cache, nxt, pos):
        return JT.decode_step(p, cache, nxt, pos, jap, JCtx())

    lg, cache = _jit(prefill, jp, jnp.asarray(prompts))
    nxt = jnp.argmax(lg[:, -1, :jcfg.vocab_size], -1).astype(jnp.int32)
    pos = jnp.full((MB,), MS, jnp.int32)
    step = jax.jit(decode).lower(jp, cache, nxt, pos).compile(
        compiler_options=FAST_COMPILE)
    toks, dec = [nxt], []
    for i in range(NEW - 1):
        ld, cache = step(jp, cache, nxt, pos + i)
        nxt = jnp.argmax(ld[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        toks.append(nxt)
        dec.append(np.asarray(ld))
    return dict(tcfg=tcfg, p1=p1, p8=p8, prompts=prompts,
                logits=np.asarray(lg), dec=np.stack(dec),
                tokens=np.stack([np.asarray(t) for t in toks], 1),
                s_max=s_max)


def test_forward_and_decode_logits_match_jax(smoke):
    tcfg, ap = smoke["tcfg"], TT.make_plan(smoke["tcfg"], 1)
    model = params_from_numpy(smoke["p1"], tcfg, "cpu")
    assert model.blocks[0].moe["router"].dtype == torch.float32
    toks = torch.tensor(smoke["prompts"]).long()
    with torch.inference_mode():
        lg, st = TT.forward_lm(model, toks, ap, collect_state=True)
        np.testing.assert_allclose(lg.numpy(), smoke["logits"],
                                   atol=ATOL_LOGITS, rtol=ATOL_LOGITS)
        cache = TT.seed_cache(TT.init_cache(ap, MB, smoke["s_max"],
                                            device="cpu"), st)
        for i in range(NEW - 1):
            got, cache = TT.decode_step(
                model, cache, torch.tensor(smoke["tokens"][:, i]).long(),
                torch.full((MB,), MS + i, dtype=torch.int32), ap)
            np.testing.assert_allclose(got.numpy(), smoke["dec"][i],
                                       atol=ATOL_LOGITS, rtol=ATOL_LOGITS)


def test_tp8_tokens_match_tp1_and_jax_local(smoke):
    """tp=8 (4 pods x 2, hier_rd): 2 experts a rank, dispatch through the
    EP all-to-all in prefill and the dense path + tp_all_reduce in decode;
    greedy tokens equal to tp=1's and to the reference's local run."""
    tcfg, ref = smoke["tcfg"], smoke["tokens"]
    m1 = params_from_numpy(smoke["p1"], tcfg, "cpu")
    tp1 = InferenceEngine(TT.make_plan(tcfg, 1), m1, s_max=smoke["s_max"],
                          device="cpu").generate(smoke["prompts"], NEW)
    mesh, ctx = mesh_and_ctx(8, 4, ar_strategy="hier_rd", device="cpu")
    m8 = params_from_numpy(smoke["p8"], tcfg, "cpu", mesh=mesh)
    assert m8.blocks[0].moe["wg"].shape == (8, 2, 64, 32)
    tp8 = InferenceEngine(TT.make_plan(tcfg, 8), m8, ctx=ctx, mesh=mesh,
                          s_max=smoke["s_max"],
                          device="cpu").generate(smoke["prompts"], NEW)
    np.testing.assert_array_equal(tp1.new_tokens, ref)
    np.testing.assert_array_equal(tp8.tokens, tp1.tokens)


def test_paged_equals_dense_and_sampling_is_seeded(smoke):
    tcfg = smoke["tcfg"]
    ap = TT.make_plan(tcfg, 1)
    model = params_from_numpy(smoke["p1"], tcfg, "cpu")
    s_max = 16

    def gen(block_size, temperature=0.0, seed=0):
        return InferenceEngine(ap, model, s_max=s_max, block_size=block_size,
                               temperature=temperature, seed=seed,
                               device="cpu").generate(smoke["prompts"],
                                                      NEW).tokens

    np.testing.assert_array_equal(gen(4), gen(0))
    sampled = gen(0, temperature=1.0, seed=3)
    np.testing.assert_array_equal(gen(4, temperature=1.0, seed=3), sampled)
    np.testing.assert_array_equal(gen(0, temperature=1.0, seed=3), sampled)


def test_dbrx_smoke_forward_at_tp1():
    cfg = dataclasses.replace(get_smoke("dbrx-132b"), dtype=torch.float32)
    ap = TT.make_plan(cfg, 1)
    model = TT.init_params(ap, seed=0, device="cpu")
    assert model.blocks[0].moe["wg"].shape == (1, 8, 64, 96)
    toks = torch.tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 8))).long()
    with torch.inference_mode():
        lg, _ = TT.forward_lm(model, toks, ap)
    assert lg.shape == (2, 8, ap.vocab_pad) and torch.isfinite(lg).all()


@pytest.mark.parametrize("extra", [[], ["--tp", "8", "--pods", "4",
                                        "--ar-strategy", "hier_rd"]],
                         ids=["tp1", "tp8-hier_rd"])
def test_serve_cli_moe_on_cpu(capsys, extra):
    res = serve.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--max-new", "3",
                      *extra])
    assert res.new_tokens.shape == (2, 3)
    line = capsys.readouterr().out
    assert "[serve] qwen3-moe-smoke on cpu" in line
    assert ("tp=8 (4x2) ar=hier_rd" in line) == bool(extra)


def test_serve_cli_moe_int8_wire_has_no_ef_leaf(capsys, monkeypatch):
    """A decode on the int8 wire: the MoE combine and attention wo are
    quantized, and the MoE family carries no error-feedback leaf, as in
    the reference; ``--layers`` cuts the depth and the line says so."""
    caches = []
    real = TT.init_cache
    monkeypatch.setattr(
        "repro_torch.parallel.steps.init_cache",
        lambda *a, **k: caches.append(real(*a, **k)) or caches[-1])
    res = serve.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--max-new", "2",
                      "--tp", "8", "--pods", "4", "--ar-strategy", "hier_rd",
                      "--ar-quant", "int8", "--layers", "1"])
    assert res.new_tokens.shape == (2, 2)
    assert caches and all("ef" not in c for c in caches)
    assert caches[0]["k"].shape[0] == 1
    line = capsys.readouterr().out
    assert "qwen3-moe-smoke (1 of 2 layers)" in line and "q=int8" in line
