"""The port's model (layers, forward, caches, decode step) held against the
JAX package on the same parameters, carried across by the bridge, at the
smoke size of llama3.2-1b (2 layers, d_model 64)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.pcontext import LOCAL  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

# Logit tolerances.  float32: both sides compute the same f32 math in
# another summation order, ~1e-6 on O(1) logits.  bfloat16: the JAX layer
# rounds attention scores and probabilities to bf16 (attn_core's bf16
# einsums) while the port's kernels keep them in f32, and the two
# frameworks round matmul outputs at other places; each bf16 rounding is
# 2^-8 relative, a few of them compound over the layers.
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S, S_MAX, BLOCK = 2, 12, 32, 8


class Pair:
    """JAX params + the port's bridged model for one dtype."""

    def __init__(self, dt):
        self.dt = dt
        self.jcfg = dataclasses.replace(jax_smoke("llama3.2-1b"),
                                        dtype=getattr(jnp, dt))
        self.tcfg = dataclasses.replace(get_smoke("llama3.2-1b"),
                                        dtype=getattr(torch, dt))
        self.jap = JT.make_plan(self.jcfg, 1)
        self.tap = TT.make_plan(self.tcfg, 1)
        self.params = jax.jit(JT.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), self.jap)
        self.model = params_from_numpy(jax.tree.map(np.asarray, self.params),
                                       self.tcfg, "cpu")
        self.j_forward = jax.jit(lambda p, t: JT.forward_lm(
            p, t, self.jap, LOCAL, collect_state=True)[::2])
        self.j_decode = jax.jit(lambda p, c, t, pos: JT.decode_step(
            p, c, t, pos, self.jap, LOCAL))


_PAIRS = {}


def get_pair(dt):
    if dt not in _PAIRS:
        _PAIRS[dt] = Pair(dt)
    return _PAIRS[dt]


@pytest.fixture(params=["float32", "bfloat16"])
def pair(request):
    return get_pair(request.param)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def test_forward_lm_logits_and_states(pair):
    toks = _tokens(1, (B, S), pair.tcfg.vocab_size)
    jl, jst = pair.j_forward(pair.params, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tst = TT.forward_lm(pair.model, torch.tensor(toks).long(),
                                pair.tap, collect_state=True)
    assert tl.shape == jl.shape and tl.dtype == pair.tcfg.dtype
    tol = TOL[pair.dt]
    _close(tl, jl, tol)
    for name in ("k", "v"):
        assert tst[name].shape == jst[name].shape
        _close(tst[name], jst[name], tol)


@pytest.mark.parametrize("block_size", [0, BLOCK], ids=["dense", "paged"])
def test_decode_step_logits(pair, block_size):
    """Prefill, seed the cache, then 3 teacher-forced decode steps."""
    vocab = pair.tcfg.vocab_size
    toks = _tokens(2, (B, S), vocab)
    steps = _tokens(3, (3, B), vocab)
    _, jst = pair.j_forward(pair.params, jnp.asarray(toks))
    jc = JT.seed_cache(JT.init_cache(pair.jap, B, S_MAX,
                                     block_size=block_size), jst)
    with torch.inference_mode():
        _, tst = TT.forward_lm(pair.model, torch.tensor(toks).long(),
                               pair.tap, collect_state=True)
        tc = TT.seed_cache(TT.init_cache(pair.tap, B, S_MAX,
                                         block_size=block_size,
                                         device="cpu"), tst)
        for i in range(3):
            pos = np.full((B,), S + i, np.int32)
            jl, jc = pair.j_decode(pair.params, jc, jnp.asarray(steps[i]),
                                   jnp.asarray(pos))
            tl, tc = TT.decode_step(pair.model, tc,
                                    torch.tensor(steps[i]).long(),
                                    torch.tensor(pos), pair.tap)
            assert tl.shape == jl.shape
            _close(tl, jl, TOL[pair.dt])
    if block_size:
        np.testing.assert_array_equal(tc["block_tbl"].numpy(),
                                      np.asarray(jc["block_tbl"]))


def test_paged_cache_splice_matches_dense_layout():
    """seed_cache through the identity table lands each position where the
    dense layout has it, and zero-pads the trailing partial block."""
    pair = get_pair("float32")
    toks = _tokens(4, (B, S), pair.tcfg.vocab_size)
    with torch.inference_mode():
        _, st = TT.forward_lm(pair.model, torch.tensor(toks).long(),
                              pair.tap, collect_state=True)
        dense = TT.seed_cache(TT.init_cache(pair.tap, B, S_MAX,
                                            device="cpu"), st)
        paged = TT.seed_cache(TT.init_cache(pair.tap, B, S_MAX,
                                            block_size=BLOCK,
                                            device="cpu"), st)
    tbl = paged["block_tbl"].long()
    for name in ("k", "v"):
        logical = paged[name][:, tbl].reshape(dense[name].shape)
        assert torch.equal(logical, dense[name])
        assert torch.count_nonzero(paged[name][:, 0]) == 0   # trash block


def test_bridge_carries_every_leaf_exactly():
    pair = get_pair("bfloat16")
    leaves = jax.tree_util.tree_flatten_with_path(pair.params)[0]
    state = pair.model.state_dict()
    assert len(state) == pair.tcfg.n_layers * 9 + 3
    for path, leaf in leaves:
        keys = [p.key for p in path]
        arr = np.asarray(leaf).astype(np.float32)
        # every leaf gains a leading rank axis, of size 1 at tp=1
        if keys[0] == "blocks":
            for i in range(pair.tcfg.n_layers):
                t = state[f"blocks.{i}.{keys[1]}.{keys[2]}"]
                assert t.shape[0] == 1
                np.testing.assert_array_equal(t[0].float().numpy(), arr[i])
        else:
            t = state[".".join(keys)]
            assert t.dtype == torch.bfloat16 and t.shape[0] == 1
            np.testing.assert_array_equal(t[0].float().numpy(), arr)


def test_own_init_matches_jax_shapes_and_scales():
    tcfg = get_smoke("llama3.2-1b")
    jp = jax.tree.map(np.asarray, get_pair("bfloat16").params)
    model = TT.init_params(TT.make_plan(tcfg, 1), seed=0, device="cpu")
    state = model.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        arr = leaf.astype(np.float32)
        if keys[0] == "blocks":
            t = torch.stack([state[f"blocks.{i}.{keys[1]}.{keys[2]}"][0]
                             for i in range(tcfg.n_layers)])
        else:
            t = state[".".join(keys)][0]
        assert tuple(t.shape) == arr.shape and t.dtype == torch.bfloat16
        # same scale: std within 15% (norms are exactly ones on both sides)
        np.testing.assert_allclose(t.float().std().item(), arr.std(),
                                   rtol=0.15, atol=1e-6)
    again = TT.init_params(TT.make_plan(tcfg, 1), seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))


@pytest.mark.parametrize("n_q,n_kv,tp", [(32, 8, 1), (4, 2, 1), (12, 4, 2),
                                         (14, 2, 4), (40, 8, 16)])
def test_plan_gqa_matches_jax(n_q, n_kv, tp):
    assert dataclasses.asdict(TC.plan_gqa(n_q, n_kv, tp)) \
        == dataclasses.asdict(JC.plan_gqa(n_q, n_kv, tp))


def test_plan_and_registry_refuse_what_the_slice_does_not_port():
    cfg = get_config("llama3.2-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.rope_theta) \
        == (16, 2048, 32, 8, 64, 8192, 128256, 5.0e5)
    assert abs(cfg.param_count() - 1.498e9) < 1e6
    ap = TT.make_plan(cfg, 1)
    assert (ap.gqa.g, ap.gqa.u) == (4, 8) and -1 not in ap.gqa.q_map
    # tp > 1 is planned now (same slots, spread over 8 ranks, none dead);
    # a tp that does not divide the widths is refused, as in the reference
    ap8 = TT.make_plan(cfg, 8)
    assert (ap8.gqa.g, ap8.gqa.u) == (4, 1) and ap8.q_mask_tbl is None
    assert ap8.gqa.q_map == ap.gqa.q_map and ap8.vocab_pad == ap.vocab_pad
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        TT.make_plan(cfg, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        TT.make_plan(dataclasses.replace(cfg, family="encdec"), 1)
    with pytest.raises(KeyError, match="ROADMAP item 10"):
        get_config("whisper-medium")
