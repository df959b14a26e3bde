"""The port's hybrid family (Hymba: ``repro_torch/models/ssm.py`` and the
hybrid branches of the model, sharding, bridge, engine and serve CLI) and
the plain version of its selective-scan kernel, held against the JAX
package on the same inputs, made with numpy from a seed: the kernel's
oracle (``ssm_scan_ref``) and one Pallas interpret case, state chaining,
the grouped A of the mesh fold, the mamba mixer (fresh, seeded, a prompt
shorter than the conv's history) and its decode step at tp=1 and on 1x4 /
2x2 meshes under nested ``jax.vmap``, then the whole smoke model (forward
and decode logits in f32 and bf16, prefill-then-decode against the full
forward past the window, tp=4 == tp=1 == JAX local tokens with dead head
slots, ``--overlap``, serve CLI paged == dense).

The mamba leaves the reference initialises to constants (A_log the same
on every channel, dt_bias 0, D_skip 1, conv_b 0, beta 1) are planted with
seeded random values, so that a wrong channel, group or mix shows.  Each
JAX function is traced once and compiled without XLA's backend
optimisations."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.pcontext import ParallelCtx as JCtx  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as pallas_scan  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_ref as jax_scan_ref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.kernels import ssm_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import row_stride  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import ssm as TSM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402

torch.set_num_threads(1)

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
ARCH = "hymba-1.5b"
# tests/test_kernels.py's SSM_CASES (B, T, Ci, S) and tolerance
SCAN_CASES = [(2, 128, 128, 16), (1, 100, 64, 8), (2, 64, 200, 16)]
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
# f32 layer outputs and logits: the reference's associative scan against
# the step loop, sums in another order; bf16: the two frameworks round at
# other places
ATOL_LAYER, ATOL_LOGITS, ATOL_BF16 = 1e-4, 1e-4, 5e-2
# the smoke window is 8: a 12-token prompt makes it bite in prefill and in
# every decode step
B, S, NEW = 2, 12, 4


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# Kernel 9's plain version
# ---------------------------------------------------------------------------


def _scan_operands(Bn, T, Ci, Sd, seed, G=1):
    """tests/test_kernels.py's draws: x, b, c normal, dt U(0.001, 0.1),
    a -U(0.5, 4) ((G, Ci, S)), h0 0.1 x normal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bn, T, Ci))
    dt = rng.uniform(0.001, 0.1, (Bn, T, Ci))
    b, c = (rng.standard_normal((Bn, T, Sd)) for _ in range(2))
    a = -rng.uniform(0.5, 4, (G, Ci, Sd))
    h0 = rng.standard_normal((Bn, Ci, Sd)) * 0.1
    return [v.astype(np.float32) for v in (x, dt, b, c, a, h0)]


def _port_scan(x, dt, b, c, a, h0=None, **kw):
    return ssm_scan(*(torch.tensor(v) for v in (x, dt, b, c, a)),
                    None if h0 is None else torch.tensor(h0), **kw)


@pytest.mark.parametrize("case", SCAN_CASES,
                         ids=[f"case{i}" for i in range(len(SCAN_CASES))])
def test_scan_plain_matches_jax_oracle(case):
    x, dt, b, c, a, h0 = _scan_operands(*case, seed=sum(case))
    want_y, want_h = _jit(jax_scan_ref, *(jnp.asarray(v) for v in
                                          (x, dt, b, c, a[0], h0)))
    y, h = _port_scan(x, dt, b, c, a, h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)


def test_scan_plain_matches_pallas_interpret():
    """One case against the TPU kernel itself, in interpret mode; T and Ci
    are not multiples of its chunk and lane block (its wrapper pads, the
    port's does not)."""
    x, dt, b, c, a, h0 = _scan_operands(1, 40, 72, 8, seed=11)
    want_y, want_h = pallas_scan(*(jnp.asarray(v) for v in
                                   (x, dt, b, c, a[0], h0)),
                                 chunk_t=16, block_c=64, interpret=True)
    y, h = _port_scan(x, dt, b, c, a, h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)


def test_scan_chains_state_in_halves_and_single_steps():
    """Two halves (the second updating its state in place, as the decode
    path does) and T = 1 steps chained, each equal to the whole run."""
    x, dt, b, c, a, h0 = _scan_operands(2, 24, 40, 16, seed=5)
    y, h = _port_scan(x, dt, b, c, a, h0)
    y1, st = _port_scan(*(v[:, :10] for v in (x, dt, b, c)), a, h0)
    y2, st2 = ssm_scan(*(torch.tensor(v[:, 10:]) for v in (x, dt, b, c)),
                       torch.tensor(a), st, h_out=st)
    assert st2 is st
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(st.numpy(), h.numpy(), atol=1e-6, rtol=1e-6)
    state, ys = torch.tensor(h0), []
    for t in range(x.shape[1]):
        yt, _ = ssm_scan(*(torch.tensor(v[:, t:t + 1]) for v in
                           (x, dt, b, c)), torch.tensor(a), state,
                         h_out=state)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(state.numpy(), h.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_scan_grouped_a_equals_per_group_calls():
    """a (G, Ci, S): sequence n reads group n // (N / G), the folded ranks
    of a mesh, each with its own channels' A."""
    x, dt, b, c, a, h0 = _scan_operands(6, 9, 24, 8, seed=3, G=3)
    y, h = _port_scan(x, dt, b, c, a, h0)
    for g in range(3):
        rows = slice(2 * g, 2 * g + 2)
        yg, hg = _port_scan(*(v[rows] for v in (x, dt, b, c)), a[g:g + 1],
                            h0[rows])
        np.testing.assert_array_equal(y[rows].numpy(), yg.numpy())
        np.testing.assert_array_equal(h[rows].numpy(), hg.numpy())


def test_scan_b_c_as_views_of_one_bc_tensor():
    """The mixer passes B and C as the two halves of one (N, T, 2S) tensor:
    the same y and state as contiguous copies, and as the JAX oracle."""
    x, dt, b, c, a, h0 = _scan_operands(2, 24, 40, 16, seed=9)
    bc = torch.tensor(np.concatenate([b, c], axis=-1))
    y, h = ssm_scan(*(torch.tensor(v) for v in (x, dt)), bc[..., :16],
                    bc[..., 16:], torch.tensor(a), torch.tensor(h0))
    yc, hc = _port_scan(x, dt, b, c, a, h0)
    np.testing.assert_array_equal(y.numpy(), yc.numpy())
    np.testing.assert_array_equal(h.numpy(), hc.numpy())
    want_y, want_h = _jit(jax_scan_ref, *(jnp.asarray(v) for v in
                                          (x, dt, b, c, a[0], h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)


@pytest.mark.parametrize("T", [1, 5])
def test_scan_row_stride_of_b_c_layouts(T):
    """The kernel's B/C addressing: rows of S contiguous floats evenly
    spaced by one stride, as contiguous tensors and the halves of one bc
    tensor (also folded from (R, B, T, 2S), as the mixer folds them) are;
    any other layout has none, and the wrapper refuses it on the card."""
    bc = torch.zeros((3, 4, T, 32))
    folded = bc.reshape(12, T, 32)
    assert row_stride(torch.zeros((12, T, 16))) == 16
    assert row_stride(folded[..., :16]) == row_stride(folded[..., 16:]) == 32
    assert row_stride(bc[..., 16:].reshape(12, T, 16)) == 32
    assert row_stride(torch.zeros((1, 1, 8))) == 8
    assert row_stride(folded[..., ::2]) is None
    if T > 1:
        assert row_stride(torch.zeros((T, 12, 16)).transpose(0, 1)) is None


def test_scan_wrapper_refusals():
    """Bad shapes raise; a tensor that is not on the CPU never reaches the
    plain version (a 'meta' tensor: neither CPU nor CUDA), and nothing
    launches."""
    x, dt, b, c, a, h0 = (torch.tensor(v) for v in
                          _scan_operands(4, 9, 16, 8, seed=4))
    before = ssm_scan.launches
    with pytest.raises(ValueError, match="not one"):
        ssm_scan(x, dt[:, :5], b, c, a)
    with pytest.raises(ValueError, match="b .* and c"):
        ssm_scan(x, dt, b, c[..., :4], a)
    with pytest.raises(ValueError, match="G dividing"):
        ssm_scan(x, dt, b, c, torch.zeros((3, 16, 8)))
    with pytest.raises(ValueError, match="h0"):
        ssm_scan(x, dt, b, c, a, torch.zeros((4, 16, 4)))
    with pytest.raises(ValueError, match="h_out"):
        ssm_scan(x, dt, b, c, a, h_out=torch.zeros((4, 8, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan(*(v.to("meta") for v in (x, dt, b, c, a)))
    assert ssm_scan.launches == before


# ---------------------------------------------------------------------------
# The mamba mixer at tp=1 and on meshes, f32
# ---------------------------------------------------------------------------


def _cfgs(dtype="float32"):
    jc = dataclasses.replace(jax_smoke(ARCH), dtype=getattr(jnp, dtype))
    tc = dataclasses.replace(get_smoke(ARCH), dtype=getattr(torch, dtype))
    return jc, tc


def _ssm_params(cfg, seed=0):
    """The mixer's group in the reference's global layout, numpy, with
    seeded random A_log (per channel), dt_bias, D_skip and conv_b."""
    rng = np.random.default_rng(seed)
    d, di, s, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.d_conv

    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)) \
            .astype(np.float32)

    def f32(v):
        return np.asarray(v, np.float32)
    return {"w_x": w((d, di), d), "w_z": w((d, di), d),
            "w_bc": w((d, 2 * s), d), "w_dt": w((d, di), d),
            "dt_bias": f32(0.5 * rng.standard_normal(di)),
            "conv_w": w((k, di), k),
            "conv_b": f32(0.1 * rng.standard_normal(di)),
            "A_log": f32(np.log(rng.uniform(1, 16, (di, s)))),
            "D_skip": f32(1 + 0.1 * rng.standard_normal(di)),
            "w_out": w((di, d), di)}


def _port(group, mesh=None):
    return TS.shard_params({"ssm": {k: torch.tensor(v) for k, v in
                                    group.items()}}, mesh)["ssm"]


def _jnp(group):
    return {k: jnp.asarray(v) for k, v in group.items()}


def _state(cfg, seed, batch=B):
    return {"conv": _np((batch, cfg.d_conv - 1, cfg.d_inner), seed),
            "ssm": _np((batch, cfg.d_inner, cfg.ssm_state), seed + 1, 0.3)}


@pytest.mark.parametrize("seeded,T", [(False, S), (True, S), (True, 2),
                                      (False, 2)],
                         ids=["fresh", "seeded", "seeded-short",
                              "fresh-short"])
def test_ssm_mixer_matches_jax(seeded, T):
    """Output, conv history and final state; T = 2 is shorter than the
    conv's history (d_conv - 1 = 3), which the reference zero-pads."""
    jcfg, tcfg = _cfgs()
    p = _ssm_params(jcfg)
    x = _np((B, T, jcfg.d_model), seed=1)
    state = _state(jcfg, 2) if seeded else None

    def run(p, x, st):
        return JS.ssm_mixer(p, x, jcfg, JCtx(), state=st, return_state=True)
    jout, jst = _jit(run, _jnp(p), jnp.asarray(x),
                     None if state is None else _jnp(state))
    tst = None if state is None else {
        "conv": torch.tensor(state["conv"])[None],
        "ssm": torch.tensor(state["ssm"])}
    out, st = TSM.ssm_mixer(_port(p), torch.tensor(x)[None], tcfg,
                            state=tst, return_state=True)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout),
                               atol=ATOL_LAYER, rtol=ATOL_LAYER)
    np.testing.assert_array_equal(st["conv"][0].numpy(),
                                  np.asarray(jst["conv"]))
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(jst["ssm"]),
                               atol=ATOL_LAYER, rtol=ATOL_LAYER)


def test_ssm_step_matches_jax_and_updates_in_place():
    jcfg, tcfg = _cfgs()
    p = _ssm_params(jcfg, seed=1)
    x = _np((B, 1, jcfg.d_model), seed=4)
    state = _state(jcfg, 5)
    jout, jst = _jit(lambda p, x, st: JS.ssm_step(p, x, st, jcfg, JCtx()),
                     _jnp(p), jnp.asarray(x), _jnp(state))
    ssm_state = torch.tensor(state["ssm"])
    out, st = TSM.ssm_step(_port(p), torch.tensor(x)[None],
                           {"conv": torch.tensor(state["conv"])[None],
                            "ssm": ssm_state}, tcfg)
    assert st["ssm"] is ssm_state
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout),
                               atol=ATOL_LAYER, rtol=ATOL_LAYER)
    np.testing.assert_array_equal(st["conv"][0].numpy(),
                                  np.asarray(jst["conv"]))
    np.testing.assert_allclose(ssm_state.numpy(), np.asarray(jst["ssm"]),
                               atol=ATOL_LAYER, rtol=ATOL_LAYER)


@pytest.mark.parametrize("layout", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_ssm_mixer_on_mesh_matches_jax(layout):
    """The d_inner-sharded leaves cut as the reference's rules cut them
    (A_log and w_out on their rows, w_bc replicated), every rank's
    TP-partial output and its state against the reference's under nested
    vmap: the ranks folded into the sequences, one A group a rank."""
    pods, fast = layout
    R = pods * fast
    jcfg, tcfg = _cfgs()
    p = _ssm_params(jcfg, seed=3)
    mesh, _ = mesh_and_ctx(R, pods, device="cpu")
    jctx = JCtx(tp_fast=("model",), tp_slow=("pod",) if pods > 1 else ())
    tp = _port(p, mesh)
    di = jcfg.d_inner // R
    assert tp["A_log"].shape == (R, di, jcfg.ssm_state)
    assert tp["w_out"].shape == (R, di, jcfg.d_model)
    assert tp["w_bc"].shape == (R, jcfg.d_model, 2 * jcfg.ssm_state)
    local = {k: v.numpy().reshape(pods, fast, *v.shape[1:])
             for k, v in tp.items()}
    x = _np((B, S, jcfg.d_model), seed=9)
    f = jax.vmap(jax.vmap(lambda p, x: JS.ssm_mixer(
        p, x, jcfg, jctx, return_state=True), in_axes=(0, None),
        axis_name="model"), in_axes=(0, None), axis_name="pod")
    jout, jst = _jit(f, _jnp(local), jnp.asarray(x))
    out, st = TSM.ssm_mixer(tp, torch.tensor(x).expand(R, B, S, -1), tcfg,
                            return_state=True)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jout).reshape(R, B, S, -1),
        atol=ATOL_LAYER, rtol=ATOL_LAYER)
    np.testing.assert_allclose(
        st["ssm"].numpy(), np.asarray(jst["ssm"]).reshape(R * B, di, -1),
        atol=ATOL_LAYER, rtol=ATOL_LAYER)


# ---------------------------------------------------------------------------
# The whole model: hymba smoke config
# ---------------------------------------------------------------------------


def _plant(tree, seed=12):
    """Seeded random values for the leaves the reference initialises to
    constants: per-channel A_log, dt_bias, D_skip, conv_b and beta."""
    rng = np.random.default_rng(seed)
    ssm = dict(tree["blocks"]["ssm"])
    ssm["A_log"] = np.log(rng.uniform(1, 16, ssm["A_log"].shape)) \
        .astype(np.float32)
    for name, mean, sd in (("dt_bias", 0.0, 0.5), ("D_skip", 1.0, 0.1),
                           ("conv_b", 0.0, 0.1)):
        ssm[name] = (mean + sd * rng.standard_normal(ssm[name].shape)) \
            .astype(np.float32)
    beta = (1 + 0.2 * rng.standard_normal(tree["blocks"]["beta"].shape)) \
        .astype(np.float32)
    return {**tree, "blocks": {**tree["blocks"], "ssm": ssm, "beta": beta}}


def _to_tp(tree, cfg, tp):
    """A tp=1 parameter tree re-laid for the plan at ``tp``: each
    attention head moved from its tp=1 slot into its slot of the tp plan
    (dead slots zero) and the vocab zero-padded to the tp's padding, so
    the two trees compute one function."""
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


_F32 = ("A_log", "D_skip", "dt_bias", "beta")


def _bf16(tree):
    """The f32 tree rounded to bf16 (the reference's f32 leaves kept), as
    float32 numpy arrays."""
    def cast(path, a):
        if path[-1].key in _F32:
            return a
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return jax.tree_util.tree_map_with_path(cast, tree)


def _jax_run(jcfg, tree, prompts, s_max):
    """The reference's greedy run at tp=1: prefill logits, each decode
    step's logits, the tokens."""
    jap = JT.make_plan(jcfg, 1)

    def leaf(path, a):
        return jnp.asarray(a, jnp.float32 if path[-1].key in _F32
                           else jcfg.dtype)
    jp = jax.tree_util.tree_map_with_path(leaf, tree)
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
    """The JAX ``init_params`` tree at tp=1 with the constant leaves
    planted, prompts, and the reference's greedy run in f32."""
    jcfg, tcfg = _cfgs()
    jap = JT.make_plan(jcfg, 1)
    key = jax.random.PRNGKey(0)
    jp = jax.jit(lambda k: JT.init_params(k, jap)).lower(key).compile(
        compiler_options=FAST_COMPILE)(key)
    tree = _plant(jax.tree.map(np.asarray, jp))
    prompts = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    s_max = S + NEW
    logits, dec, tokens = _jax_run(jcfg, tree, prompts, s_max)
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, prompts=prompts,
                s_max=s_max, logits=logits, dec=dec, tokens=tokens)


def _decode_logits(model, ap, prompts, tokens, s_max, ctx=None, mesh=None,
                   block_size=0):
    """Prefill the prompts, then feed ``tokens`` (B, n) one decode step at
    a time; logits of the prefill's last position and of every step."""
    kw = {} if ctx is None else {"ctx": ctx, "mesh": mesh}
    Bn, Sn = prompts.shape
    with torch.inference_mode():
        lg, st = TT.forward_lm(model, torch.tensor(prompts).long(), ap,
                               collect_state=True, **kw)
        cache = TT.seed_cache(TT.init_cache(ap, Bn, s_max, device="cpu",
                                            mesh=mesh, block_size=block_size),
                              st)
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


def test_forward_and_decode_logits_match_jax(smoke):
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


def test_bf16_forward_and_decode_match_jax(smoke):
    """bf16 weights and activations (A_log, D_skip, dt_bias, beta f32):
    the two frameworks round at other places, hence the looser bar.  The
    conv is rounded tap by tap in prefill and once in decode in both."""
    jcfg, tcfg = _cfgs("bfloat16")
    tree = _bf16(smoke["tree"])
    logits, dec, _ = _jax_run(jcfg, tree, smoke["prompts"], smoke["s_max"])
    ap = TT.make_plan(tcfg, 1)
    model = params_from_numpy(tree, tcfg, "cpu")
    got = _decode_logits(model, ap, smoke["prompts"],
                         smoke["tokens"][:, :NEW - 1], smoke["s_max"]).float()
    np.testing.assert_allclose(got[:, 0].numpy(), logits[:, -1],
                               atol=ATOL_BF16, rtol=ATOL_BF16)
    np.testing.assert_allclose(got[:, 1:].numpy(), dec.transpose(1, 0, 2),
                               atol=ATOL_BF16, rtol=ATOL_BF16)


@pytest.mark.parametrize("block_size", [0, 4], ids=["dense", "paged"])
def test_prefill_then_decode_equals_full_forward(smoke, block_size):
    """The decode path (windowed decode attention, kernel 9 at T = 1 on
    the cache's state in place, the conv history) over prompt + tokens
    gives the full forward's logits at every position, the 8-token window
    biting in both; paged K/V with the recurrent leaves batch-indexed."""
    tcfg, ap = smoke["tcfg"], TT.make_plan(smoke["tcfg"], 1)
    model = params_from_numpy(smoke["tree"], tcfg, "cpu")
    toks = smoke["tokens"]
    got = _decode_logits(model, ap, smoke["prompts"], toks, S + NEW + 4,
                         block_size=block_size)
    with torch.inference_mode():
        full, _ = TT.forward_lm(model, torch.tensor(np.concatenate(
            [smoke["prompts"], toks], 1)).long(), ap)
    np.testing.assert_allclose(got.numpy(), full[:, S - 1:].numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout,strategy", [((2, 2), "hier_rd"),
                                             ((2, 2), "flat"),
                                             ((1, 4), "flat")],
                         ids=["2x2-hier_rd", "2x2-flat", "1x4-flat"])
def test_tp4_tokens_and_logits_match_tp1_and_jax_local(smoke, layout,
                                                       strategy):
    """tp=4: 5 q / 5 kv heads in 8 slots (3 dead of each), d_inner cut to
    32 a rank, one A group a rank; the decode path's logits (vocab shards
    gathered) within f32 rounding of tp=1's, greedy tokens equal to
    tp=1's and to the reference's local run."""
    tcfg = smoke["tcfg"]
    pods, fast = layout
    mesh, ctx = mesh_and_ctx(4, pods, ar_strategy=strategy, device="cpu")
    ap1, ap4 = TT.make_plan(tcfg, 1), TT.make_plan(tcfg, 4)
    assert (ap4.gqa.g, ap4.gqa.u) == (1, 2) and ap4.q_mask_tbl is not None
    assert ap4.d_inner_local == tcfg.d_inner // 4
    m1 = params_from_numpy(smoke["tree"], tcfg, "cpu")
    m4 = params_from_numpy(_to_tp(smoke["tree"], tcfg, 4), tcfg, "cpu",
                           mesh=mesh)
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


def test_overlap_tokens_equal_tokens_without_it(smoke):
    """``--overlap`` on this family overlaps the MLP's down projection
    only (the attention partial is mixed before its reduction): the same
    greedy tokens as without it."""
    tcfg = smoke["tcfg"]
    mesh, ctx = mesh_and_ctx(4, 2, ar_strategy="hier_rd", device="cpu")
    ap4 = TT.make_plan(tcfg, 4)
    m4 = params_from_numpy(_to_tp(smoke["tree"], tcfg, 4), tcfg, "cpu",
                           mesh=mesh)
    toks = [InferenceEngine(ap4, m4, ctx=ctx.replace(overlap_matmul=ov),
                            mesh=mesh, s_max=smoke["s_max"], device="cpu")
            .generate(smoke["prompts"], NEW).tokens for ov in (False, True)]
    np.testing.assert_array_equal(toks[0], toks[1])
    np.testing.assert_array_equal(toks[0][:, S:], smoke["tokens"])


def test_bridge_sharding_and_plan_of_the_hybrid_family(smoke):
    """A_log, D_skip, dt_bias and beta stay f32 in a bf16 model; the mamba
    leaves are cut on d_inner, w_bc and beta replicated; no hybrid leaf
    meets another family's rule; a tp that does not divide d_inner is
    refused; the full config's tp=8 plan has dead slots."""
    _, tcfg = _cfgs("bfloat16")
    model = params_from_numpy(smoke["tree"], tcfg, "cpu")
    b0 = model.blocks[0]
    for name in ("A_log", "D_skip", "dt_bias"):
        assert b0.ssm[name].dtype == torch.float32
    assert b0.beta.dtype == torch.float32 and b0.beta.shape == (1, 2)
    assert b0.ssm["w_x"].dtype == b0.mlp["wg"].dtype == torch.bfloat16
    np.testing.assert_array_equal(b0.ssm["A_log"][0].numpy(),
                                  smoke["tree"]["blocks"]["ssm"]["A_log"][0])
    for name, dim in (("w_x", 1), ("w_z", 1), ("w_dt", 1), ("w_out", 0),
                      ("A_log", 0), ("conv_w", 1), ("conv_b", 0),
                      ("dt_bias", 0), ("D_skip", 0)):
        assert TS.tp_dim(("ssm", name), 2 if name not in
                         ("conv_b", "dt_bias", "D_skip") else 1) == dim
    assert TS.tp_dim(("ssm", "w_bc"), 2) is None is TS.tp_dim(("beta",), 1)
    hybrid_leaves = set(smoke["tree"]["blocks"]["ssm"]) | {"beta"}
    assert not hybrid_leaves & {"w", "b", "mu", "wk", "wv", "wr", "u", "w0"}
    with pytest.raises(ValueError, match="d_inner=128 not divisible by "
                                         "tp=3"):
        TT.make_plan(dataclasses.replace(tcfg, d_model=63, d_ff=129,
                                         n_heads=3, n_kv_heads=3), 3)
    ap8 = TT.make_plan(get_config(ARCH), 8)
    assert (ap8.gqa.g, ap8.gqa.u, ap8.d_inner_local) == (2, 2, 400)
    assert list(ap8.gqa.q_map).count(-1) == 7
    assert list(ap8.gqa.kv_map).count(-1) == 1
    assert ap8.vocab_pad == 32008


def test_param_count_is_every_leaf(smoke):
    """The port counts every leaf (the full (D, d_inner) w_dt, w_bc, beta
    and the norms), where the reference's count assumes a low-rank dt
    projection its init does not build (ROADMAP §3): the smoke model's
    leaves in the port and in the JAX tree, and the full model's JAX leaf
    count (traced, not built)."""
    tcfg = smoke["tcfg"]
    model = TT.init_params(TT.make_plan(tcfg, 1), seed=0, device="cpu")
    n_port = sum(p.numel() for p in model.parameters())
    n_jax = sum(a.size for a in jax.tree.leaves(smoke["tree"]))
    assert tcfg.param_count() == n_port == n_jax == 174276
    full = jax_config(ARCH)
    shapes = jax.eval_shape(lambda k: JT.init_params(k, JT.make_plan(full, 1)),
                            jax.random.PRNGKey(0))
    n_full = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert get_config(ARCH).param_count() == n_full == 1803883264
    assert full.param_count() == 1661443200
    assert jax_smoke(ARCH).param_count() == 162176


@pytest.mark.parametrize("extra", [[], ["--tp", "4", "--pods", "2",
                                        "--ar-strategy", "hier_rd"]],
                         ids=["tp1-paged", "tp4-hier_rd"])
def test_serve_cli_hymba_on_cpu(capsys, extra):
    """The CLI at tp=1 runs paged (block 16) and dense, with equal tokens;
    on the mesh, dense."""
    argv = ["--arch", ARCH, "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--max-new", "3", *extra]
    res = serve.main(argv)
    assert res.new_tokens.shape == (2, 3)
    line = capsys.readouterr().out
    assert "[serve] hymba-smoke on cpu" in line and "conv/ssm state" in line
    assert ("tp=4 (2x2) ar=hier_rd" in line) == bool(extra)
    if not extra:
        paged = serve.main(argv + ["--block-size", "16"])
        assert "paged(bs=16)" in capsys.readouterr().out
        np.testing.assert_array_equal(paged.tokens, res.tokens)
