"""The port's ssm family (RWKV6: ``repro_torch/models/rwkv.py`` and the ssm
branches of the model, sharding, bridge, engine and serve CLI) and the
plain version of its time-mix scan kernel, held against the JAX package on
the same inputs, made with numpy from a seed: the kernel's oracle
(``rwkv_scan_ref``, step-exact, also past the reference's chunk clamp) and
one Pallas interpret case, the time-mix (full sequence, seeded, one step)
and channel-mix layers with a nonzero bonus ``u``, the channel-mix over
1x4 and 2x2 meshes under nested ``jax.vmap``, then the whole smoke model
(forward and decode logits in f32 and bf16, prefill-then-decode against
the full forward, tp=4 == tp=1 == JAX local tokens, serve CLI).

Every comparison that goes through the reference's chunked scan asserts
that the inputs' deepest 64-step decay sum stays above -60, where that
form is right (ROADMAP §3).  Each JAX function is traced once and
compiled without XLA's backend optimisations."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.pcontext import ParallelCtx as JCtx  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_scan  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.kernels import rwkv6_scan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.common import pad_to  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402

torch.set_num_threads(1)

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
ARCH = "rwkv6-7b"
# tests/test_kernels.py's RWKV_CASES (B, T, H, hd) and tolerances
SCAN_CASES = [(2, 128, 2, 64), (1, 100, 3, 64), (2, 64, 1, 32)]
SCAN_TOL = dict(atol=2e-4, rtol=1e-3)
# The reference's chunk: its chunked form is right while every 64-step
# decay sum stays above -CLAMP (ROADMAP §3)
CHUNK, CLAMP = 64, 60.0
# f32 layer outputs and logits: the same math, the chunked form against
# the step-exact one and sums in another order
ATOL_LAYER, ATOL_LOGITS, ATOL_BF16 = 1e-4, 1e-4, 5e-2
B, S, NEW = 2, 8, 4


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def deepest_decay(logws) -> float:
    """The most negative sum of 64 consecutive log decays (or of all of
    them, when fewer) over every sequence, head and channel."""
    worst = 0.0
    for lw in logws:
        cs = np.cumsum(np.asarray(lw, np.float64), axis=1)
        n = min(CHUNK, cs.shape[1])
        win = cs[:, n - 1:] - np.concatenate(
            [np.zeros_like(cs[:, :1]), cs[:, :-n]], axis=1)
        worst = min(worst, float(win.min()))
    return worst


@pytest.fixture
def logw_log(monkeypatch):
    """Records the log decays every port time-mix hands kernel 8."""
    seen = []
    real = TR.rwkv6_scan

    def spy(r, k, v, logw, *a, **kw):
        seen.append(logw.detach().float().numpy())
        return real(r, k, v, logw, *a, **kw)

    monkeypatch.setattr(TR, "rwkv6_scan", spy)
    return seen


# ---------------------------------------------------------------------------
# Kernel 8's plain version
# ---------------------------------------------------------------------------


def _scan_operands(Bn, T, H, hd, seed, logw=None):
    """tests/test_kernels.py's draws: r/k/v normal, log decay
    -exp(U(-6, -0.5)) (or the constant ``logw``), u and s0 0.1 x normal."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((Bn, T, H, hd)) for _ in range(3))
    lw = -np.exp(rng.uniform(-6, -0.5, (Bn, T, H, hd))) if logw is None \
        else np.full((Bn, T, H, hd), logw)
    u = rng.standard_normal((H, hd)) * 0.1
    s0 = rng.standard_normal((Bn, H, hd, hd)) * 0.1
    return [a.astype(np.float32) for a in (r, k, v, lw, u, s0)]


def _port_scan(r, k, v, lw, u, s0):
    return rwkv6_scan(*(torch.tensor(a) for a in (r, k, v, lw)),
                      torch.tensor(u)[None], torch.tensor(s0))


CONSTANT_DECAYS = (-1.0, -2.0, -5.0)


@pytest.mark.parametrize(
    "case,const", [(c, None) for c in SCAN_CASES]
    + [((1, 64, 1, 32), c) for c in CONSTANT_DECAYS],
    ids=[f"case{i}" for i in range(len(SCAN_CASES))]
    + [f"logw{c:g}" for c in CONSTANT_DECAYS])
def test_scan_plain_matches_step_exact_reference(case, const):
    """The shapes of the JAX kernel test, and constant log decays -1, -2,
    -5, where the reference's chunked form is off by up to 34 (its clamp)
    and the port's scan must not be."""
    ops = _scan_operands(*case, seed=sum(case), logw=const)
    want_y, want_s = (np.asarray(a) for a in JR.rwkv_scan_ref(
        *(jnp.asarray(a) for a in ops)))
    y, s = _port_scan(*ops)
    np.testing.assert_allclose(y.numpy(), want_y, **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), want_s, **SCAN_TOL)
    if const is not None:
        chunked, _ = JR.rwkv_scan_chunked(*(jnp.asarray(a) for a in ops))
        assert deepest_decay([ops[3]]) < -CLAMP
        assert np.abs(np.asarray(chunked) - want_y).max() > 1.0


def test_scan_plain_matches_pallas_interpret():
    """One case against the TPU kernel itself, in interpret mode, with log
    decays >= -0.61 (the range of the JAX tests, where it is right); T is
    not a multiple of its chunk (its wrapper pads, the port's does not)."""
    ops = _scan_operands(1, 100, 2, 32, seed=11)
    assert ops[3].min() >= -0.61 and deepest_decay([ops[3]]) > -CLAMP
    want_y, want_s = pallas_scan(*(jnp.asarray(a) for a in ops), chunk=32,
                                 interpret=True)
    y, s = _port_scan(*ops)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **SCAN_TOL)


def test_scan_chains_state_and_steps_in_place():
    """Two chained calls (the second updating its state in place, as the
    decode path does) equal one call; T = 1 equals one reference step."""
    r, k, v, lw, u, s0 = _scan_operands(2, 37, 3, 32, seed=5)
    y, s = _port_scan(r, k, v, lw, u, s0)
    y1, s1 = _port_scan(r[:, :20], k[:, :20], v[:, :20], lw[:, :20], u, s0)
    st = s1.clone()
    y2, s2 = rwkv6_scan(*(torch.tensor(a[:, 20:]) for a in (r, k, v, lw)),
                        torch.tensor(u)[None], st, s_out=st)
    assert s2 is st
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(st.numpy(), s.numpy(), atol=1e-6, rtol=1e-6)
    one = [a[:, :1] for a in (r, k, v, lw)]
    want_y, want_s = JR.rwkv_scan_ref(*(jnp.asarray(a) for a in one),
                                      jnp.asarray(u), jnp.asarray(s0))
    y, s = _port_scan(*one, u, s0)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **SCAN_TOL)


def test_scan_grouped_bonus_and_wrapper_checks():
    """u (G, H, hd): sequence n reads group n // (N / G), the folded ranks
    of a mesh; bad shapes raise; a tensor that is not on the CPU never
    reaches the plain version (a 'meta' tensor: neither CPU nor CUDA), and
    nothing launches."""
    r, k, v, lw, _, s0 = _scan_operands(4, 9, 2, 32, seed=3)
    ug = _np((2, 2, 32), seed=4, scale=0.3)
    y, s = rwkv6_scan(*(torch.tensor(a) for a in (r, k, v, lw)),
                      torch.tensor(ug), torch.tensor(s0))
    for n in range(4):
        want_y, want_s = JR.rwkv_scan_ref(
            *(jnp.asarray(a[n:n + 1]) for a in (r, k, v, lw)),
            jnp.asarray(ug[n // 2]), jnp.asarray(s0[n:n + 1]))
        np.testing.assert_allclose(y[n:n + 1].numpy(), np.asarray(want_y),
                                   **SCAN_TOL)
        np.testing.assert_allclose(s[n:n + 1].numpy(), np.asarray(want_s),
                                   **SCAN_TOL)
    t = [torch.tensor(a) for a in (r, k, v, lw)]
    before = rwkv6_scan.launches
    with pytest.raises(ValueError, match="G dividing"):
        rwkv6_scan(*t, torch.zeros((3, 2, 32)))
    with pytest.raises(ValueError, match="not one"):
        rwkv6_scan(t[0], t[1][:, :5], *t[2:], torch.zeros((1, 2, 32)))
    with pytest.raises(ValueError, match="s0"):
        rwkv6_scan(*t, torch.zeros((1, 2, 32)), torch.zeros((4, 2, 32, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan(*(a.to("meta") for a in t),
                   torch.zeros((1, 2, 32), device="meta"))
    assert rwkv6_scan.launches == before


# ---------------------------------------------------------------------------
# The layers at tp=1, f32, with a nonzero bonus u
# ---------------------------------------------------------------------------


def _cfgs(dtype="float32"):
    jc = dataclasses.replace(jax_smoke(ARCH), dtype=getattr(jnp, dtype))
    tc = dataclasses.replace(get_smoke(ARCH), dtype=getattr(torch, dtype))
    return jc, tc


def _layer_params(cfg, seed=0):
    """Time-mix and channel-mix groups in the reference's global layout,
    numpy: random shift mixes, norm affine and bonus u (the reference
    initialises u to zero, which would leave the bonus term untested)."""
    rng = np.random.default_rng(seed)
    d, f, lo, hd = cfg.d_model, cfg.d_ff, cfg.decay_lora, cfg.rwkv_head_dim

    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)) \
            .astype(np.float32)

    def f32(a):
        return np.asarray(a, np.float32)
    tm = {"mu": f32(rng.uniform(0, 1, (5, d))), "w_r": w((d, d), d),
          "w_k": w((d, d), d), "w_v": w((d, d), d), "w_g": w((d, d), d),
          "w0": f32(np.tile(np.linspace(-6.0, -0.5, hd), d // hd)),
          "w_a": w((d, lo), d), "w_b": w((lo, d), lo),
          "u": f32(rng.standard_normal(d) * 0.5),
          "ln_w": f32(1 + 0.1 * rng.standard_normal(d)),
          "ln_b": f32(0.1 * rng.standard_normal(d)), "w_o": w((d, d), d)}
    cm = {"mu": f32(rng.uniform(0, 1, (2, d))), "wk": w((d, f), d),
          "wv": w((f, d), f), "wr": w((d, d), d)}
    return tm, cm


def _port(group, name, mesh=None):
    return TS.shard_params({name: {k: torch.tensor(v) for k, v in
                                   group.items()}}, mesh)[name]


def _jnp(group):
    return {k: jnp.asarray(v) for k, v in group.items()}


@pytest.mark.parametrize("seeded", [False, True], ids=["fresh", "seeded"])
def test_time_mix_matches_jax(seeded, logw_log):
    jcfg, tcfg = _cfgs()
    tm, _ = _layer_params(jcfg)
    H, hd = jcfg.d_model // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    x = _np((B, S, jcfg.d_model), seed=1)
    state = {"shift_tm": _np((B, jcfg.d_model), seed=2),
             "wkv": _np((B, H, hd, hd), seed=3, scale=0.3)} if seeded \
        else None

    def run(p, x, st):
        return JR.rwkv_time_mix(p, x, jcfg, JCtx(), state=st,
                                return_state=True)
    jout, jst = _jit(run, _jnp(tm), jnp.asarray(x),
                     None if state is None else _jnp(state))
    tst = None if state is None else {
        "shift_tm": torch.tensor(state["shift_tm"])[None],
        "wkv": torch.tensor(state["wkv"])}
    out, st = TR.rwkv_time_mix(_port(tm, "tm"), torch.tensor(x)[None], tcfg,
                               state=tst, return_state=True)
    assert deepest_decay(logw_log) > -CLAMP
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout),
                               atol=ATOL_LAYER, rtol=ATOL_LAYER)
    np.testing.assert_allclose(st["wkv"].numpy(), np.asarray(jst["wkv"]),
                               atol=ATOL_LAYER, rtol=ATOL_LAYER)
    np.testing.assert_array_equal(st["shift_tm"][0].numpy(),
                                  np.asarray(jst["shift_tm"]))


def test_time_mix_step_matches_jax_and_updates_in_place():
    jcfg, tcfg = _cfgs()
    tm, _ = _layer_params(jcfg, seed=1)
    H, hd = jcfg.d_model // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    x = _np((B, 1, jcfg.d_model), seed=4)
    state = {"shift_tm": _np((B, jcfg.d_model), seed=5),
             "wkv": _np((B, H, hd, hd), seed=6, scale=0.3)}
    jout, jst = _jit(lambda p, x, st: JR.rwkv_time_mix_step(
        p, x, st, jcfg, JCtx()), _jnp(tm), jnp.asarray(x), _jnp(state))
    wkv = torch.tensor(state["wkv"])
    out, st = TR.rwkv_time_mix_step(
        _port(tm, "tm"), torch.tensor(x)[None],
        {"shift_tm": torch.tensor(state["shift_tm"])[None], "wkv": wkv},
        tcfg)
    assert st["wkv"] is wkv
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout),
                               atol=ATOL_LAYER, rtol=ATOL_LAYER)
    np.testing.assert_allclose(wkv.numpy(), np.asarray(jst["wkv"]),
                               atol=ATOL_LAYER, rtol=ATOL_LAYER)


def test_channel_mix_matches_jax():
    jcfg, tcfg = _cfgs()
    _, cm = _layer_params(jcfg, seed=2)
    x = _np((B, S, jcfg.d_model), seed=7)
    prev = _np((B, jcfg.d_model), seed=8)
    jout, jst = _jit(lambda p, x, pv: JR.rwkv_channel_mix(
        p, x, jcfg, JCtx(), state={"shift_cm": pv}, return_state=True),
        _jnp(cm), jnp.asarray(x), jnp.asarray(prev))
    out, st = TR.rwkv_channel_mix(_port(cm, "cm"), torch.tensor(x)[None],
                                  tcfg,
                                  state={"shift_cm": torch.tensor(prev)[None]},
                                  return_state=True)
    assert out.shape == (1, 2, B, S, jcfg.d_model)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout),
                               atol=ATOL_LAYER, rtol=ATOL_LAYER)
    np.testing.assert_array_equal(st["shift_cm"][0].numpy(),
                                  np.asarray(jst["shift_cm"]))


@pytest.mark.parametrize("layout", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_channel_mix_on_mesh_matches_jax(layout):
    """Each rank contracts its own D/R slice of xr with its rows of wr
    (the reference through ``tp_rank`` under nested vmap, the port by an
    index over the rank axis): the stacked partials of every rank."""
    pods, fast = layout
    R = pods * fast
    jcfg, tcfg = _cfgs()
    _, cm = _layer_params(jcfg, seed=3)
    mesh, ctx = mesh_and_ctx(R, pods, device="cpu")
    jctx = JCtx(tp_fast=ctx.tp_fast, tp_slow=ctx.tp_slow)
    tp = _port(cm, "cm", mesh)
    assert tp["wk"].shape == (R, jcfg.d_model, jcfg.d_ff // R)
    assert tp["wr"].shape == (R, jcfg.d_model // R, jcfg.d_model)
    local = {k: v.numpy().reshape(pods, fast, *v.shape[1:])
             for k, v in tp.items()}
    x = _np((B, S, jcfg.d_model), seed=9)
    f = jax.vmap(jax.vmap(lambda p, x: JR.rwkv_channel_mix(p, x, jcfg, jctx),
                          in_axes=(0, None), axis_name="model"),
                 in_axes=(0, None), axis_name="pod")
    want = np.asarray(_jit(f, _jnp(local), jnp.asarray(x)))
    got = TR.rwkv_channel_mix(tp, torch.tensor(x).expand(R, B, S, -1), tcfg)
    np.testing.assert_allclose(got.numpy(), want.reshape(R, *want.shape[2:]),
                               atol=ATOL_LAYER, rtol=ATOL_LAYER)


# ---------------------------------------------------------------------------
# The whole model: rwkv6 smoke config
# ---------------------------------------------------------------------------


def _to_tp(tree, cfg, tp):
    """The tp=1 tree with the vocab zero-padded to the padding at tp (the
    ssm family has no head slots to move): one function at both tps."""
    pad = pad_to(cfg.vocab_size, tp) - tree["embed"]["tok"].shape[0]
    return {**tree, "embed": {
        "tok": np.pad(tree["embed"]["tok"], ((0, pad), (0, 0))),
        "head": np.pad(tree["embed"]["head"], ((0, 0), (0, pad)))}}


def _plant_u(tree, seed=12):
    """A nonzero bonus u in every layer (the reference's init is zero)."""
    u = tree["blocks"]["tm"]["u"]
    blocks = {**tree["blocks"], "tm": {**tree["blocks"]["tm"],
                                       "u": _np(u.shape, seed, 0.5)}}
    return {**tree, "blocks": blocks}


def _bf16(tree):
    """The f32 tree rounded to bf16 (w0 and u kept f32, as the reference
    keeps them), as float32 numpy arrays."""
    def cast(path, a):
        if path[-1].key in ("w0", "u"):
            return a
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return jax.tree_util.tree_map_with_path(cast, tree)


def _jax_run(jcfg, tree, prompts, s_max):
    """The reference's greedy run at tp=1: prefill logits, each decode
    step's logits, the tokens."""
    jap = JT.make_plan(jcfg, 1)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jcfg.dtype), tree)
    jp["blocks"]["tm"]["w0"] = jnp.asarray(tree["blocks"]["tm"]["w0"])
    jp["blocks"]["tm"]["u"] = jnp.asarray(tree["blocks"]["tm"]["u"])
    mb, ms = prompts.shape

    def prefill(p, tok):
        lg, _, st, _ = JT.forward_lm(p, tok, jap, JCtx(), collect_state=True)
        return lg, JT.seed_cache(JT.init_cache(jap, mb, s_max), st)

    def decode(p, cache, nxt, pos):
        return JT.decode_step(p, cache, nxt, pos, jap, JCtx())

    lg, cache = _jit(prefill, jp, jnp.asarray(prompts))
    nxt = jnp.argmax(lg[:, -1, :jcfg.vocab_size], -1).astype(jnp.int32)
    pos = jnp.full((mb,), ms, jnp.int32)
    step = jax.jit(decode).lower(jp, cache, nxt, pos).compile(
        compiler_options=FAST_COMPILE)
    toks, dec = [nxt], []
    for i in range(NEW - 1):
        ld, cache = step(jp, cache, nxt, pos + i)
        nxt = jnp.argmax(ld[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        toks.append(nxt)
        dec.append(np.asarray(ld, np.float32))
    return (np.asarray(lg, np.float32), np.stack(dec),
            np.stack([np.asarray(t) for t in toks], 1))


@pytest.fixture(scope="module")
def smoke():
    """The JAX ``init_params`` tree at tp=1 with a planted bonus u,
    prompts, and the reference's greedy run in f32."""
    jcfg, tcfg = _cfgs()
    jap = JT.make_plan(jcfg, 1)
    key = jax.random.PRNGKey(0)
    jp = jax.jit(lambda k: JT.init_params(k, jap)).lower(key).compile(
        compiler_options=FAST_COMPILE)(key)
    tree = _plant_u(jax.tree.map(np.asarray, jp))
    prompts = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    s_max = S + NEW
    logits, dec, tokens = _jax_run(jcfg, tree, prompts, s_max)
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, prompts=prompts,
                s_max=s_max, logits=logits, dec=dec, tokens=tokens)


def _decode_logits(model, ap, prompts, tokens, s_max, ctx=None, mesh=None):
    """Prefill the prompts, then feed ``tokens`` (B, n) one decode step at
    a time; logits of the prefill's last position and of every step."""
    kw = {} if ctx is None else {"ctx": ctx, "mesh": mesh}
    Bn, Sn = prompts.shape
    with torch.inference_mode():
        lg, st = TT.forward_lm(model, torch.tensor(prompts).long(), ap,
                               collect_state=True, **kw)
        cache = TT.seed_cache(TT.init_cache(ap, Bn, s_max, device="cpu",
                                            mesh=mesh), st)
        out = [lg[..., -1, :]]
        for i in range(tokens.shape[1]):
            d, cache = TT.decode_step(
                model, cache, torch.tensor(tokens[:, i]).long(),
                torch.full((Bn,), Sn + i, dtype=torch.int32), ap, **kw)
            out.append(d)
    return torch.stack(out, dim=-2)


def _gathered(lg):
    """Vocab-sharded logits (R, ..., V_local) -> (..., R * V_local)."""
    return lg.movedim(0, -2).flatten(-2)


def test_forward_and_decode_logits_match_jax(smoke, logw_log):
    tcfg, ap = smoke["tcfg"], TT.make_plan(smoke["tcfg"], 1)
    model = params_from_numpy(smoke["tree"], tcfg, "cpu")
    with torch.inference_mode():
        lg, _ = TT.forward_lm(model, torch.tensor(smoke["prompts"]).long(),
                              ap)
    np.testing.assert_allclose(lg.numpy(), smoke["logits"],
                               atol=ATOL_LOGITS, rtol=ATOL_LOGITS)
    got = _decode_logits(model, ap, smoke["prompts"],
                         smoke["tokens"][:, :NEW - 1], smoke["s_max"])
    np.testing.assert_allclose(got[:, 1:].numpy(),
                               smoke["dec"].transpose(1, 0, 2),
                               atol=ATOL_LOGITS, rtol=ATOL_LOGITS)
    assert deepest_decay(logw_log) > -CLAMP


def test_bf16_forward_and_decode_match_jax(smoke, logw_log):
    """bf16 weights and activations (w0 and u f32): the two frameworks
    round at other places, hence the looser bar."""
    jcfg, tcfg = _cfgs("bfloat16")
    tree = _bf16(smoke["tree"])
    logits, dec, _ = _jax_run(jcfg, tree, smoke["prompts"], smoke["s_max"])
    ap = TT.make_plan(tcfg, 1)
    model = params_from_numpy(tree, tcfg, "cpu")
    got = _decode_logits(model, ap, smoke["prompts"],
                         smoke["tokens"][:, :NEW - 1], smoke["s_max"]).float()
    with torch.inference_mode():
        lg, _ = TT.forward_lm(model, torch.tensor(smoke["prompts"]).long(),
                              ap)
    np.testing.assert_allclose(lg.float().numpy(), logits, atol=ATOL_BF16,
                               rtol=ATOL_BF16)
    np.testing.assert_allclose(got[:, 1:].numpy(), dec.transpose(1, 0, 2),
                               atol=ATOL_BF16, rtol=ATOL_BF16)
    assert deepest_decay(logw_log) > -CLAMP


def test_prefill_then_decode_equals_full_forward(smoke):
    """The decode path (kernel 8 at T = 1 on the cache's state, in place)
    over prompt + tokens gives the full forward's logits at every
    position: the recurrence is step-exact in both."""
    tcfg, ap = smoke["tcfg"], TT.make_plan(smoke["tcfg"], 1)
    model = params_from_numpy(smoke["tree"], tcfg, "cpu")
    toks = smoke["tokens"]
    got = _decode_logits(model, ap, smoke["prompts"], toks, S + NEW + 1)
    with torch.inference_mode():
        full, _ = TT.forward_lm(model, torch.tensor(np.concatenate(
            [smoke["prompts"], toks], 1)).long(), ap)
    np.testing.assert_allclose(got.numpy(), full[:, S - 1:].numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout,strategy", [((1, 4), "hier_rd"),
                                             ((1, 4), "flat"),
                                             ((2, 2), "hier_rd"),
                                             ((2, 2), "flat")],
                         ids=["1x4-hier_rd", "1x4-flat", "2x2-hier_rd",
                              "2x2-flat"])
def test_tp4_tokens_and_logits_match_tp1_and_jax_local(smoke, layout,
                                                       strategy):
    """tp=4: 8 heads of 32 cut to 2 a rank, wr row-sharded; the decode
    path's logits (vocab shards gathered) within f32 rounding of tp=1's,
    and greedy tokens equal to tp=1's and the reference's local run."""
    tcfg = smoke["tcfg"]
    pods, fast = layout
    mesh, ctx = mesh_and_ctx(4, pods, ar_strategy=strategy, device="cpu")
    ap1, ap4 = TT.make_plan(tcfg, 1), TT.make_plan(tcfg, 4)
    assert ap4.rwkv_heads_local == 1 and ap4.gqa is None
    m1 = params_from_numpy(smoke["tree"], tcfg, "cpu")
    m4 = params_from_numpy(_to_tp(smoke["tree"], tcfg, 4), tcfg, "cpu",
                           mesh=mesh)
    assert m4.blocks[0].tm["w_o"].shape == (4, tcfg.d_model // 4,
                                            tcfg.d_model)
    toks = smoke["tokens"][:, :NEW - 1]
    want = _decode_logits(m1, ap1, smoke["prompts"], toks, smoke["s_max"])
    got = _gathered(_decode_logits(m4, ap4, smoke["prompts"], toks,
                                   smoke["s_max"], ctx, mesh))
    np.testing.assert_allclose(got[..., :tcfg.vocab_size].numpy(),
                               want[..., :tcfg.vocab_size].numpy(),
                               atol=ATOL_LOGITS, rtol=ATOL_LOGITS)
    res = InferenceEngine(ap4, m4, ctx=ctx, mesh=mesh, s_max=smoke["s_max"],
                          device="cpu").generate(smoke["prompts"], NEW)
    tp1 = InferenceEngine(ap1, m1, s_max=smoke["s_max"],
                          device="cpu").generate(smoke["prompts"], NEW)
    np.testing.assert_array_equal(tp1.new_tokens, smoke["tokens"])
    np.testing.assert_array_equal(res.tokens, tp1.tokens)


def test_bridge_sharding_and_plan_of_the_ssm_family():
    """u and w0 stay f32 in a bf16 model; under a ``cm`` parent wk is cut
    on its columns (the attention rule would cut its rows), wv and wr on
    their rows; a tp that does not divide the heads is refused."""
    jcfg, tcfg = _cfgs("bfloat16")
    tm, cm = _layer_params(jcfg)
    L = tcfg.n_layers
    blocks = {"ln1": {"w": np.ones((L, tcfg.d_model), np.float32)},
              "tm": {k: np.stack([v] * L) for k, v in tm.items()},
              "ln2": {"w": np.ones((L, tcfg.d_model), np.float32)},
              "cm": {k: np.stack([v] * L) for k, v in cm.items()}}
    emb = {"tok": _np((97, tcfg.d_model), 1), "head": _np((tcfg.d_model, 97),
                                                           2)}
    model = params_from_numpy({"embed": emb, "blocks": blocks,
                               "final_norm": {"w": blocks["ln1"]["w"][0]}},
                              tcfg, "cpu")
    b0 = model.blocks[0]
    assert b0.tm["u"].dtype == b0.tm["w0"].dtype == torch.float32
    assert b0.tm["w_r"].dtype == b0.cm["wr"].dtype == torch.bfloat16
    np.testing.assert_array_equal(b0.tm["u"][0].numpy(), tm["u"])
    assert TS.tp_dim(("cm", "wk"), 2) == 1 and TS.tp_dim(("attn", "wk"),
                                                         3) == 1
    assert TS.tp_dim(("cm", "wv"), 2) == 0 == TS.tp_dim(("cm", "wr"), 2)
    assert TS.tp_dim(("tm", "w_o"), 2) == 0 and TS.tp_dim(("tm", "u"), 1) == 0
    assert TS.tp_dim(("tm", "w_a"), 2) is None
    assert TS.tp_dim(("cm", "mu"), 2) is None is TS.tp_dim(("tm", "mu"), 2)
    with pytest.raises(ValueError, match="4 heads of 32 not divisible by "
                                         "tp=8"):
        TT.make_plan(tcfg, 8)
    assert TT.make_plan(get_config(ARCH), 8).rwkv_heads_local == 8


def test_param_count_is_every_leaf(smoke):
    """The port counts every leaf (the time-mix w_o included, which the
    reference's count leaves out, ROADMAP §3): the smoke model's leaves in
    the port and in the JAX tree, and the full model's JAX leaf count."""
    tcfg = smoke["tcfg"]
    model = TT.init_params(TT.make_plan(tcfg, 1), seed=0, device="cpu")
    n_port = sum(p.numel() for p in model.parameters())
    n_jax = sum(a.size for a in jax.tree.leaves(smoke["tree"]))
    assert tcfg.param_count() == n_port == n_jax == 360064
    full = get_config(ARCH)
    d, L = full.d_model, full.n_layers
    assert full.param_count() == 7534678016
    assert jax_config(ARCH).param_count() == 6996099072
    assert full.param_count() - jax_config(ARCH).param_count() \
        == L * (d * d + 13 * d) + d       # w_o and the small leaves


@pytest.mark.parametrize("extra", [[], ["--tp", "4", "--pods", "2",
                                        "--ar-strategy", "hier_rd"]],
                         ids=["tp1", "tp4-hier_rd"])
def test_serve_cli_rwkv_on_cpu(capsys, extra):
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--max-new", "3", *extra])
    assert res.new_tokens.shape == (2, 3)
    line = capsys.readouterr().out
    assert "[serve] rwkv6-smoke on cpu" in line
    assert ("tp=4 (2x2) ar=hier_rd" in line) == bool(extra)


def test_serve_cli_rwkv_refuses_a_paged_cache():
    with pytest.raises(ValueError, match="no K/V to page"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--max-new", "2",
                    "--block-size", "4"])
