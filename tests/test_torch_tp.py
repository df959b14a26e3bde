"""The port's tensor-parallel path over the virtual mesh held against the
JAX package's TP path: the GQA plan and its q mask, parameter sharding
against ``parallel/sharding.py::param_specs``, ``forward_lm`` logits
against the JAX ``forward_lm`` under nested ``jax.vmap`` (the port's rank
axis is that vmap's picture of ``shard_map``), and greedy tokens of the
mesh engine against tp=1 and the JAX local engine (the port's version of
``tests/dist_cases/case_decode_parity.py``)."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.pcontext import ParallelCtx as JCtx  # noqa: E402
from repro.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

B, S = 4, 8
# f32 logits: the same math in another summation order (the rank sums of
# the collectives included), ~1e-6 on O(1) logits.
ATOL = 1e-5
TINY = dict(family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=96)


def _cfgs(**kw):
    base = dict(TINY, **kw)
    return (JC.ModelConfig(name="tiny", dtype=jnp.float32, **base),
            TC.ModelConfig(name="tiny", dtype=torch.float32, **base))


def _jax_ctx(tctx):
    return JCtx(tp_fast=tctx.tp_fast, tp_slow=tctx.tp_slow,
                ar_strategy=tctx.ar_strategy, rd_chunks=tctx.rd_chunks)


def _rank_slices(leaf, spec, pods, fast):
    """Per-rank pieces of a global leaf under a PartitionSpec over the
    (pod, model) mesh, stacked slow-major: (R, *local)."""
    sizes = {"pod": pods, "model": fast}
    out = []
    for p in range(pods):
        for f in range(fast):
            coord = {"pod": p, "model": f}
            idx = []
            for d, e in enumerate(tuple(spec) + (None,) * leaf.ndim):
                if d >= leaf.ndim:
                    break
                if e is None:
                    idx.append(slice(None))
                    continue
                axes = e if isinstance(e, tuple) else (e,)
                n, k = 1, 0
                for a in axes:
                    k = k * sizes[a] + coord[a]
                    n *= sizes[a]
                step = leaf.shape[d] // n
                idx.append(slice(k * step, (k + 1) * step))
            out.append(leaf[tuple(idx)])
    return np.stack(out)


class TPCase:
    """JAX tp=N params, their per-rank slices, and the bridged port model
    on a (pods, fast) virtual mesh."""

    def __init__(self, pods, fast, strategy, **cfg_kw):
        self.pods, self.fast, tp = pods, fast, pods * fast
        self.jcfg, self.tcfg = _cfgs(**cfg_kw)
        self.mesh, self.ctx = mesh_and_ctx(tp, pods, ar_strategy=strategy,
                                           device="cpu")
        self.jctx = _jax_ctx(self.ctx)
        self.jap, self.tap = JT.make_plan(self.jcfg, tp), \
            TT.make_plan(self.tcfg, tp)
        self.params = jax.tree.map(np.asarray, jax.jit(
            JT.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                              self.jap))
        mesh_stub = types.SimpleNamespace(axis_names=("pod", "model"),
                                          devices=np.empty((pods, fast)))
        specs = JS.param_specs(self.params, self.jctx, mesh_stub)
        self.local = jax.tree.map(
            lambda a, s: _rank_slices(a, s, pods, fast), self.params, specs,
            is_leaf=lambda x: isinstance(x, np.ndarray))
        self.model = params_from_numpy(self.params, self.tcfg, "cpu",
                                       mesh=self.mesh)

    def jax_forward(self, tokens):
        """JAX forward_lm logits on every rank: (R, B, S, V_local)."""
        ap, ctx = self.jap, self.jctx

        def fwd(p, t):
            return JT.forward_lm(p, t, ap, ctx)[0]

        f = jax.vmap(jax.vmap(fwd, in_axes=(0, None), axis_name="model"),
                     in_axes=(0, None), axis_name="pod")
        tree = jax.tree.map(lambda a: a.reshape(self.pods, self.fast,
                                                *a.shape[1:]), self.local)
        out = np.asarray(jax.jit(f)(tree, jnp.asarray(tokens)))
        return out.reshape(self.pods * self.fast, *out.shape[2:])


def _gather_vocab(logits):
    """(R, B, S, V_local) -> (B, S, R * V_local), rank r's slice r-th."""
    R = logits.shape[0]
    return np.moveaxis(np.asarray(logits), 0, -2).reshape(
        *logits.shape[1:-1], R * logits.shape[-1])


def _prompts(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


@pytest.mark.parametrize("n_q,n_kv,tp", [(32, 8, 8), (4, 2, 8), (6, 2, 4),
                                         (6, 2, 2), (4, 2, 4), (5, 5, 8),
                                         (12, 4, 16)])
def test_plan_gqa_and_q_mask_match_jax(n_q, n_kv, tp):
    t, j = TC.plan_gqa(n_q, n_kv, tp), JC.plan_gqa(n_q, n_kv, tp)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    np.testing.assert_array_equal(t.q_mask(), j.q_mask())
    assert t.q_slots_local == j.q_slots_local
    jcfg, tcfg = _cfgs(n_heads=n_q, n_kv_heads=n_kv, head_dim=8,
                       d_model=16 * tp, d_ff=16 * tp)
    jt, tt = JT.make_plan(jcfg, tp).q_mask_tbl, \
        TT.make_plan(tcfg, tp).q_mask_tbl
    assert (jt is None) == (tt is None)
    if jt is not None:
        np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("layout", [(1, 4), (4, 2)],
                         ids=lambda v: f"{v[0]}x{v[1]}")
def test_shard_params_equal_param_specs_slices(layout):
    case = TPCase(*layout, "hier_rd")
    state = case.model.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(case.local)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i in range(case.tcfg.n_layers):
                t = state[f"blocks.{i}.{keys[1]}.{keys[2]}"]
                np.testing.assert_array_equal(t.numpy(), leaf[:, i])
        else:
            np.testing.assert_array_equal(state[".".join(keys)].numpy(),
                                          leaf)


@pytest.mark.parametrize("layout,strategy,cfg_kw", [
    ((1, 4), "flat", {}),
    ((2, 4), "hier_rd", {}),
    ((2, 4), "hier_rd_halving", {}),
    ((2, 2), "hier_rd", dict(n_heads=6, n_kv_heads=2)),
], ids=["1x4-flat", "2x4-hier_rd", "2x4-hier_rd_halving",
        "2x2-hier_rd-dead_q_slots"])
def test_forward_lm_logits_match_jax_tp(layout, strategy, cfg_kw):
    case = TPCase(*layout, strategy, **cfg_kw)
    if cfg_kw:
        assert case.tap.q_mask_tbl is not None     # dead q slots
    toks = _prompts(case.tcfg.vocab_size)
    want = case.jax_forward(toks)
    with torch.inference_mode():
        got, states = TT.forward_lm(case.model, torch.tensor(toks).long(),
                                    case.tap, case.ctx, case.mesh,
                                    collect_state=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(_gather_vocab(got.numpy()),
                               _gather_vocab(want), atol=ATOL, rtol=ATOL)
    R = case.mesh.size
    assert states["k"].shape == (case.tcfg.n_layers, R * B, S,
                                 case.tap.gqa.u, case.tcfg.head_dim)


@pytest.mark.parametrize("layout,strategy", [((2, 4), "hier_rd"),
                                             ((2, 2), "hier_ring")],
                         ids=["2x4-hier_rd", "2x2-hier_ring"])
def test_decode_step_logits_match_jax_tp(layout, strategy):
    """Prefill, seed the rank-local caches, then 2 teacher-forced decode
    steps: the port's decode_step logits against the JAX decode_step
    under nested vmap."""
    case = TPCase(*layout, strategy)
    toks = _prompts(case.tcfg.vocab_size, seed=3)
    steps = np.random.default_rng(4).integers(
        0, case.tcfg.vocab_size, (2, B)).astype(np.int32)
    ap, ctx, s_max = case.jap, case.jctx, S + 4

    def run(p, t, nxt):
        _, _, st, _ = JT.forward_lm(p, t, ap, ctx, collect_state=True)
        c = JT.seed_cache(JT.init_cache(ap, B, s_max), st)
        out = []
        for i in range(2):
            lg, c = JT.decode_step(p, c, nxt[i], jnp.full((B,), S + i,
                                                          jnp.int32), ap, ctx)
            out.append(lg)
        return jnp.stack(out)

    f = jax.vmap(jax.vmap(run, in_axes=(0, None, None), axis_name="model"),
                 in_axes=(0, None, None), axis_name="pod")
    tree = jax.tree.map(lambda a: a.reshape(case.pods, case.fast,
                                            *a.shape[1:]), case.local)
    want = np.asarray(jax.jit(f)(tree, jnp.asarray(toks),
                                 jnp.asarray(steps)))
    want = want.reshape(case.mesh.size, *want.shape[2:])   # (R, 2, B, V)
    with torch.inference_mode():
        _, st = TT.forward_lm(case.model, torch.tensor(toks).long(),
                              case.tap, case.ctx, case.mesh,
                              collect_state=True)
        cache = TT.seed_cache(TT.init_cache(case.tap, B, s_max, device="cpu",
                                            mesh=case.mesh), st)
        for i in range(2):
            got, cache = TT.decode_step(
                case.model, cache, torch.tensor(steps[i]).long(),
                torch.full((B,), S + i, dtype=torch.int32), case.tap,
                case.ctx, case.mesh)
            np.testing.assert_allclose(got.numpy(), want[:, i], atol=ATOL,
                                       rtol=ATOL)


def test_mesh_engine_tokens_match_tp1_and_jax_local():
    """tp=8 (4 pods x 2, hier_rd, 3 decode steps) gives the greedy tokens
    of the port at tp=1 and of the JAX local engine: the dead kv and q
    slots of the tp=8 plan carry zero weights, so the three compute one
    function."""
    case = TPCase(4, 2, "hier_rd")
    jap1 = JT.make_plan(case.jcfg, 1)
    p1 = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   jap1)
    prompts = _prompts(case.tcfg.vocab_size, seed=2)
    ref = JaxEngine(jap1, p1, s_max=S + 4).generate(prompts, 4)
    tap1 = TT.make_plan(case.tcfg, 1)
    m1 = params_from_numpy(jax.tree.map(np.asarray, p1), case.tcfg, "cpu")
    tp1 = InferenceEngine(tap1, m1, s_max=S + 4,
                          device="cpu").generate(prompts, 4)
    tp8 = InferenceEngine(case.tap, case.model, ctx=case.ctx,
                          mesh=case.mesh, s_max=S + 4,
                          device="cpu").generate(prompts, 4)
    np.testing.assert_array_equal(tp8.tokens, tp1.tokens)
    np.testing.assert_array_equal(tp8.tokens, ref.tokens)
    assert tp8.new_tokens.dtype == np.int32 and tp8.steps == 4


def test_mesh_engine_runs_paged_cache_and_sampling():
    """The mesh engine pages its cache (one pool a rank, folded) with the
    dense cache's tokens, and samples over the gathered vocab from each
    row's seeded chain; chunked admission is what still refuses."""
    case = TPCase(2, 2, "hier_rd")
    kw = dict(ctx=case.ctx, mesh=case.mesh, s_max=32, device="cpu")
    prompts = _prompts(case.tcfg.vocab_size, seed=4)

    def gen(**k):
        return InferenceEngine(case.tap, case.model, **kw, **k) \
            .generate(prompts, 4).tokens

    np.testing.assert_array_equal(gen(block_size=8), gen())
    sampled = gen(temperature=1.0, top_k=8, seed=3)
    np.testing.assert_array_equal(gen(temperature=1.0, top_k=8, seed=3,
                                      block_size=8), sampled)
    assert sampled[:, -4:].max() < case.tcfg.vocab_size
    assert not np.array_equal(gen(temperature=1.0, top_k=8, seed=4), sampled)
    from repro_torch.inference.scheduler import ContinuousBatcher
    with pytest.raises(NotImplementedError, match="ROADMAP item 6b"):
        ContinuousBatcher(case.tap, case.model, admit_mode="chunked", **kw)
    with pytest.raises(ValueError, match="VirtualMesh"):
        InferenceEngine(case.tap, case.model, s_max=32, device="cpu")


@pytest.mark.parametrize("axis,item", [("dp", "item 11"),
                                       ("fsdp", "item 11"),
                                       ("sp", "item 9")])
def test_layout_refuses_non_tp_axes(axis, item):
    """A ctx with batch, weight or sequence axes is refused, not run as if
    they were absent."""
    tcfg = _cfgs()[1]
    mesh, ctx = mesh_and_ctx(4, 2, ar_strategy="hier_rd", device="cpu")
    TT.check_layout(TT.make_plan(tcfg, 4), ctx, mesh)
    ctx = ctx.replace(**{axis: ("model",)})
    with pytest.raises(NotImplementedError, match=item):
        TT.check_layout(TT.make_plan(tcfg, 4), ctx, mesh)
    with pytest.raises(NotImplementedError, match=item):
        TT.check_layout(TT.make_plan(tcfg, 1), ctx.replace(
            tp_fast=(), tp_slow=()), None)


def test_serve_cli_tp_on_cpu(capsys):
    res = serve.main(["--arch", "llama3.2-1b", "--mode", "batch",
                      "--device", "cpu", "--tp", "8", "--pods", "4",
                      "--ar-strategy", "hier_rd", "--batch", "2",
                      "--prompt-len", "8", "--max-new", "4"])
    assert res.new_tokens.shape == (2, 4)
    assert res.new_tokens.max() < 97
    assert "tp=8 (4x2) ar=hier_rd" in capsys.readouterr().out


def test_seeded_init_is_one_function_at_every_tp():
    """The port's seeded init draws ``tok``/``head`` at the real vocab and
    zero-pads them to the plan's padding, before any block draw: llama3.2-1b
    smoke (vocab 97, padded to 100 at tp=4) in f32 at tp=4 (2 x 2) and at
    tp=1 from one seed give the same logits over the real vocab (4.58
    apart on these tokens when the draws followed the padded shapes)."""
    from repro_torch.configs import get_smoke
    tcfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype=torch.float32)
    mesh, ctx = mesh_and_ctx(4, 2, ar_strategy="flat", device="cpu")
    ap1, ap4 = TT.make_plan(tcfg, 1), TT.make_plan(tcfg, 4)
    assert ap4.vocab_pad == 100 != tcfg.vocab_size
    tokens = torch.tensor(_prompts(tcfg.vocab_size, seed=3)[:2]).long()
    with torch.inference_mode():
        lg1, _ = TT.forward_lm(TT.init_params(ap1, seed=0, device="cpu"),
                               tokens, ap1)
        m4 = TT.init_params(ap4, seed=0, device="cpu", mesh=mesh)
        lg4, _ = TT.forward_lm(m4, tokens, ap4, ctx, mesh)
    lg4 = lg4.movedim(0, -2).flatten(-2)
    v = tcfg.vocab_size
    np.testing.assert_allclose(lg4[..., :v].numpy(), lg1[..., :v].numpy(),
                               atol=1e-5, rtol=1e-5)
    assert not m4.embed["tok"].reshape(-1, tcfg.d_model)[v:].any()
