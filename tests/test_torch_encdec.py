"""The encoder-decoder family (``whisper-medium``; its smoke config here)
in the port, held against the JAX package on bridged f32 weights: the
configs field by field and ``param_count`` against every leaf; the
layernorm, the tanh-gelu MLP and the cross-attention layers; the forward
with precomputed frame embeddings (the encoder, every decoder block's
cross-attention, the cross K/V seeds); prefill then teacher-forced
decode steps against the full forward and against the JAX decode step;
greedy ``generate(extra=)`` against the JAX engine's; paged == dense;
tp=4 (2 x 2, hier_rd) against tp=1 and against the JAX TP path under
nested ``jax.vmap``; sequence-parallel prefill on == off at 2 x 2 and
against the JAX SP forward at one pod; the refusals (the batcher, trace
mode, speculative decoding, disaggregated serving, the prefix cache);
and one serve CLI run.

The helpers here (:func:`cfgs`, :func:`extras`, :func:`jax_run`,
:func:`port_run`, :func:`jax_tp_forward`, :func:`pad_vocab`,
:func:`relay`, :func:`sp_pair`, :func:`margin_gate`) are shared with
``test_torch_vlm.py``."""
import dataclasses
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.core.pcontext import LOCAL as JLOCAL  # noqa: E402
from repro.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.core import hierarchical as TH  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.core.pcontext import LOCAL  # noqa: E402
from repro_torch.inference.disagg import PrefillPool  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.inference.scheduler import ContinuousBatcher  # noqa: E402
from repro_torch.inference.spec import ReplicaSpec, SpecError  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.common import pad_to, plan_gqa  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from test_torch_dense_archs import _leaves, _same_fields  # noqa: E402
from test_torch_kvquant import FAST_COMPILE, jax_tree  # noqa: E402
from test_torch_tp import _jax_ctx, _rank_slices  # noqa: E402

torch.set_num_threads(1)

ARCH = "whisper-medium"
B, S, NEW = 2, 8, 4
S_MAX, BLOCK = 16, 8
# f32 logits: the same math in another summation order (~1e-6 on O(1)
# logits); the layers alone ~1e-7
TOL, LAYER_TOL = 1e-4, 1e-5
# decode == full forward (the reference's tests/test_cache_consistency.py)
REL = 2e-3


def cfgs(arch):
    """The arch's smoke config in f32, the JAX package's and the port's."""
    return (dataclasses.replace(JR.get_smoke(arch), dtype=jnp.float32),
            dataclasses.replace(get_smoke(arch), dtype=torch.float32))


def extras(cfg, b=B, seed=11):
    """The frames or patches of ``b`` prompts, numpy f32 from a seed."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frame_embeds": rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    return {"patch_embeds": rng.standard_normal(
        (b, cfg.n_patches, cfg.d_model)).astype(np.float32)}


def tokens(vocab, b=B, s=S + NEW, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def jax_run(jcfg, tree, toks, extra, s, *, block_size=0):
    """The reference at tp=1: the prefill's logits over the first s tokens
    (B, s, V), and its decode path's, (B, T - s + 1, V): the prefill's
    last, then each later token fed one decode step at a time (the cross
    K/V seeded by ``cross_kv``, as its engine seeds them)."""
    jap = JT.make_plan(jcfg, 1)
    params = jax.tree.map(jnp.asarray, tree)
    ex = {k: jnp.asarray(v) for k, v in extra.items()}
    b, t = toks.shape

    def prefill(p, tok, ex):
        lg, _, st, enc = JT.forward_lm(p, tok, jap, JLOCAL,
                                       collect_state=True, **ex)
        enc_kv = None if enc is None else jax.vmap(
            lambda bp: JL.cross_kv(bp["xattn"], enc))(p["blocks"])
        cache = JT.init_cache(jap, b, S_MAX, block_size=block_size)
        return lg, JT.seed_cache(cache, st, enc_kv=enc_kv)

    def decode(p, cache, tk, pos):
        return JT.decode_step(p, cache, tk, pos, jap, JLOCAL)

    def compiled(fn, *args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options=FAST_COMPILE)

    tok = jnp.asarray(toks)
    pre = jnp.asarray(toks[:, :s])
    want, cache = compiled(prefill, params, pre, ex)(params, pre, ex)
    pos = jnp.full((b,), s, jnp.int32)
    step = compiled(decode, params, cache, tok[:, s], pos)
    out = [np.asarray(want[:, -1])]
    for i in range(t - s):
        lg, cache = step(params, cache, tok[:, s + i], pos + i)
        out.append(np.asarray(lg))
    return np.asarray(want), np.stack(out, 1)


def port_run(ap, model, toks, extra, s, *, ctx=LOCAL, mesh=None,
             block_size=0, sp=None):
    """The port's full forward over ``toks`` (B, T, V) and the counterpart
    of :func:`jax_run`'s decode path (logits gathered to the full padded
    vocab on a mesh), and the prefill's states."""
    b, t = toks.shape
    ex = {k: torch.as_tensor(v) for k, v in extra.items()}

    def full(lg):
        if mesh is None:
            return lg.numpy()
        return lg.movedim(0, -2).reshape(*lg.shape[1:-1], -1).numpy()

    tk = torch.as_tensor(toks).long()
    with torch.inference_mode():
        want, _ = TT.forward_lm(model, tk, ap, ctx, mesh, sp=sp, **ex)
        lg, st = TT.forward_lm(model, tk[:, :s], ap, ctx, mesh, sp=sp,
                               collect_state=True, **ex)
        cache = TT.seed_cache(TT.init_cache(
            ap, b, S_MAX, block_size=block_size, device="cpu", mesh=mesh),
            st)
        out = [full(lg[..., -1, :])]
        for i in range(t - s):
            ld, _ = TT.decode_step(model, cache, tk[:, s + i],
                                   torch.full((b,), s + i, dtype=torch.int32),
                                   ap, ctx, mesh)
            out.append(full(ld))
    return full(want), np.stack(out, 1), st


def pad_vocab(tree, tp):
    """A tp=1 tree with its vocab zero-padded to the tp plan's (the same
    function over the real vocab)."""
    v = tree["embed"]["tok"].shape[0]
    pad = pad_to(v, tp) - v
    return {**tree, "embed": {
        "tok": np.pad(tree["embed"]["tok"], ((0, pad), (0, 0))),
        "head": np.pad(tree["embed"]["head"], ((0, 0), (0, pad)))}}


def relay(tree, cfg, tp):
    """A tp=1 tree re-laid for the plan at ``tp``: each head of ``attn``
    (and ``xattn``) moved from its tp=1 slot into its slot of the tp plan
    (dead slots zero, kv heads replicated where the plan does), the vocab
    zero-padded; one function at either tp."""
    one, many = plan_gqa(cfg.n_heads, cfg.n_kv_heads, 1), \
        plan_gqa(cfg.n_heads, cfg.n_kv_heads, tp)
    maps = {"q": (one.q_map, many.q_map), "kv": (one.kv_map, many.kv_map)}
    axes = {"wq": (2, "q"), "wk": (2, "kv"), "wv": (2, "kv"), "wo": (1, "q"),
            "bq": (1, "q"), "bk": (1, "kv"), "bv": (1, "kv")}

    def move(a, axis, m1, mn):
        heads = np.take(a, [list(m1).index(h) for h in range(max(m1) + 1)],
                        axis=axis)
        m = np.asarray(mn)
        live = (m >= 0).reshape([-1 if i == axis else 1
                                 for i in range(a.ndim)])
        return np.where(live, np.take(heads, np.maximum(m, 0), axis=axis),
                        0).astype(a.dtype)

    def group(g):
        return {n: move(a, axes[n][0], *maps[axes[n][1]])
                for n, a in g.items()}

    out = pad_vocab(tree, tp)
    for part in ("blocks", "enc_blocks"):
        if part in tree:
            out[part] = {**tree[part], **{n: group(tree[part][n])
                                          for n in ("attn", "xattn")
                                          if n in tree[part]}}
    return out


def jax_tp_forward(jcfg, tree, ctx, pods, fast, toks, extra, sp=False):
    """The JAX ``forward_lm`` on every rank of a (pods, fast) mesh under
    nested ``jax.vmap`` (the port's rank axis), the tree cut as its
    ``param_specs`` cut it: logits (R, B, S, V_local)."""
    jap, jctx = JT.make_plan(jcfg, pods * fast), _jax_ctx(ctx)
    stub = types.SimpleNamespace(axis_names=("pod", "model"),
                                 devices=np.empty((pods, fast)))
    specs = JS.param_specs(tree, jctx, stub)

    def cut(a, spec):
        r = _rank_slices(a, spec, pods, fast)
        return r.reshape(pods, fast, *r.shape[1:])

    local = jax.tree.map(cut, tree, specs,
                         is_leaf=lambda x: isinstance(x, np.ndarray))

    def fwd(p, t, ex):
        return JT.forward_lm(p, t, jap, jctx, sp=sp, **ex)[0]

    f = jax.vmap(jax.vmap(fwd, in_axes=(0, None, None), axis_name="model"),
                 in_axes=(0, None, None), axis_name="pod")
    args = (local, jnp.asarray(toks),
            {k: jnp.asarray(v) for k, v in extra.items()})
    out = jax.jit(f).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
    return np.asarray(out).reshape(pods * fast, *out.shape[2:])


def gathered(lg):
    """(R, B, S, V_local) -> (B, S, R * V_local)."""
    return np.moveaxis(lg, 0, -2).reshape(*lg.shape[1:-1], -1)


@pytest.fixture(scope="module")
def whisper():
    jcfg, tcfg = cfgs(ARCH)
    tree = jax_tree(jcfg)
    toks, extra = tokens(jcfg.vocab_size), extras(jcfg)
    want, dec = jax_run(jcfg, tree, toks, extra, S)
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, toks=toks, extra=extra,
                want=want, dec=dec, ap=TT.make_plan(tcfg, 1),
                model=params_from_numpy(tree, tcfg, "cpu"))


def test_configs_param_count_and_sharding():
    """The registered configs equal the reference's field by field;
    ``param_count`` is every leaf of the seeded init, the reference's
    count plus the leaves it leaves out (the gelu MLP's ``b1``, every
    norm's ``w`` and ``b``, ``ln_x`` and ``enc_norm``); the encoder's
    leaves take the sharding rules of their names."""
    assert ARCH in ARCH_IDS
    _same_fields(get_config(ARCH), JR.get_config(ARCH))
    _same_fields(get_smoke(ARCH), JR.get_smoke(ARCH))
    cfg = get_smoke(ARCH)
    assert _leaves(cfg) == cfg.param_count()
    for ours, ref in ((cfg, JR.get_smoke(ARCH)),
                      (get_config(ARCH), JR.get_config(ARCH))):
        d, f = ours.d_model, ours.d_ff
        extra = ours.n_layers * (3 * 2 * d + f) \
            + ours.enc_layers * (2 * 2 * d + f) + 2 * 2 * d
        assert ours.param_count() == ref.param_count() + extra
    assert get_config(ARCH).param_count() == 811_309_056
    for path, nd, want in ((("mlp", "w1"), 2, 1), (("mlp", "b1"), 1, 0),
                           (("mlp", "w2"), 2, 0), (("ln_x", "b"), 1, None),
                           (("xattn", "wq"), 3, 1), (("xattn", "wo"), 3, 0),
                           (("enc_norm", "b"), 1, None)):
        assert TS.tp_dim(path, nd) == want, path


def test_layers_match_jax(whisper):
    """layer_norm, the tanh-gelu MLP and the cross-attention (prefill
    through kernel 3's non-causal form, decode through kernel 1 at every
    row's last encoder key) against the JAX layers, f32."""
    jcfg, tcfg = whisper["jcfg"], whisper["tcfg"]
    tree = whisper["tree"]["blocks"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, jcfg.enc_seq, jcfg.d_model)) \
        .astype(np.float32)

    def layer(name):
        g = {k: np.array(a[0]) for k, a in tree[name].items()}
        if "b" in g:      # a planted bias: the init's zeros hide a wrong add
            g["b"] = rng.standard_normal(g["b"].shape).astype(np.float32)
        if "b1" in g:
            g["b1"] = rng.standard_normal(g["b1"].shape).astype(np.float32)
        return g, {k: torch.as_tensor(a)[None] for k, a in g.items()}

    (jn, tn), (jm, tm), (jx, tx) = layer("ln_x"), layer("mlp"), \
        layer("xattn")
    jap = JT.make_plan(jcfg, 1)

    def ref(jn, jm, jx, x, enc):
        ek, ev = JL.cross_kv(jx, enc)
        return (JL.apply_norm(x, jn, jcfg), JL.mlp(jm, x, jcfg), ek,
                *(JL.cross_attention(jx, x[:, :s], ek, ev, jcfg, jap.gqa,
                                     JLOCAL) for s in (S, 1)))

    args = (jn, jm, jx, jnp.asarray(x), jnp.asarray(enc))
    want = jax.jit(ref).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
    xt = torch.as_tensor(x)[None]
    tk, tv = TL.cross_kv(tx, torch.as_tensor(enc)[None])
    got = [TL.apply_norm(xt, tn, tcfg),
           torch.einsum("rbsf,rfd->rbsd", TL.mlp_hidden(tm, xt, tcfg),
                        TL.mlp_down_w(tm, tcfg)), tk]
    for s, decode in ((S, False), (1, True)):
        heads = TL.cross_attention(tx, xt[:, :, :s], TL._fold(tk),
                                   TL._fold(tv), decode=decode)
        got.append(torch.einsum("rbsqh,rqhd->rbsd", heads, tx["wo"]))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(r),
                                   atol=LAYER_TOL, rtol=0)


def test_forward_and_decode_match_jax(whisper):
    """The forward's logits (the prompt's) and the teacher-forced decode
    path's against JAX (TOL); decode == the full forward (REL, the
    reference's cache-consistency bar); the cross K/V seeds equal JAX's
    ``cross_kv`` of its encoder's output."""
    w = whisper
    v = w["tcfg"].vocab_size
    full, dec, st = port_run(w["ap"], w["model"], w["toks"], w["extra"], S)
    np.testing.assert_allclose(full[:, :S], w["want"], atol=TOL, rtol=0)
    np.testing.assert_allclose(dec, w["dec"], atol=TOL, rtol=0)
    ref = full[:, S - 1:-1]
    rel = np.abs(dec[:, :-1] - ref[:, :dec.shape[1] - 1]).max() \
        / np.abs(ref).max()
    assert rel < REL, rel
    jap = JT.make_plan(w["jcfg"], 1)

    def enc_k(p, frames):
        enc = JT.encoder_forward(p, frames, jap, JLOCAL, sp=False)
        return jax.vmap(lambda bp: JL.cross_kv(bp["xattn"], enc)[0])(
            p["blocks"])

    args = (jax.tree.map(jnp.asarray, w["tree"]),
            jnp.asarray(w["extra"]["frame_embeds"]))
    ek = jax.jit(enc_k).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
    assert st["enc_k"].shape == (w["tcfg"].n_layers, B, w["tcfg"].enc_seq,
                                 w["ap"].gqa.u, w["tcfg"].head_dim)
    np.testing.assert_allclose(st["enc_k"].numpy(), np.asarray(ek),
                               atol=TOL, rtol=0)
    assert full.shape[-1] == v


def margin_gate(ours, ref, ref_logits, s, tol=1e-4):
    """Tokens equal at every step until the first whose reference
    top-1/top-2 gap is within 2 tol; returns the steps checked."""
    top2 = -np.sort(-np.asarray(ref_logits, np.float32), axis=-1)[..., :2]
    gap = top2[..., 0] - top2[..., 1]
    checked = 0
    for b in range(ours.shape[0]):
        for t in range(ours.shape[1] - s):
            if gap[b, s - 1 + t] <= 2 * tol:
                break
            assert ours[b, s + t] == ref[b, s + t], (b, t)
            checked += 1
    return checked


def test_generate_matches_jax_engine_and_paged_equals_dense(whisper):
    """Greedy ``generate(extra=)`` against the JAX engine's, gated on the
    reference's top-1/top-2 gap; the paged cache (the cross K/V dense
    beside it) gives the dense tokens bitwise."""
    w = whisper
    prompts = w["toks"][:, :S]
    ref = JaxEngine(JT.make_plan(w["jcfg"], 1), jax.tree.map(
        jnp.asarray, w["tree"]), s_max=S_MAX).generate(
        prompts, NEW, extra={k: jnp.asarray(a) for k, a in
                             w["extra"].items()})
    runs = {bs: InferenceEngine(w["ap"], w["model"], s_max=S_MAX,
                                block_size=bs, device="cpu").generate(
        prompts, NEW, extra=w["extra"]) for bs in (0, BLOCK)}
    full, _, _ = port_run(w["ap"], w["model"], ref.tokens, w["extra"], S)
    assert margin_gate(runs[0].tokens, ref.tokens, full, S) >= B
    np.testing.assert_array_equal(runs[BLOCK].tokens, runs[0].tokens)


def test_tp4_matches_tp1_and_the_jax_tp_path(whisper):
    """On a 2 x 2 mesh (hier_rd) the forward and the decode path equal
    tp=1's within TOL, and the forward equals the JAX TP forward under
    nested vmap on the same (vocab-padded) tree."""
    w = whisper
    tree4 = pad_vocab(w["tree"], 4)
    mesh, ctx = mesh_and_ctx(4, 2, ar_strategy="hier_rd", device="cpu")
    ap4 = TT.make_plan(w["tcfg"], 4)
    model4 = params_from_numpy(tree4, w["tcfg"], "cpu", mesh=mesh)
    full, dec, _ = port_run(ap4, model4, w["toks"], w["extra"], S, ctx=ctx,
                            mesh=mesh)
    v = w["tcfg"].vocab_size
    np.testing.assert_allclose(full[:, :S, :v], w["want"], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(dec[..., :v], w["dec"], atol=TOL, rtol=0)
    jtp = gathered(jax_tp_forward(w["jcfg"], tree4, ctx, 2, 2, w["toks"],
                                  w["extra"]))
    np.testing.assert_allclose(full, jtp, atol=TOL, rtol=0)


def count_rs(fn):
    """(fn's result, how many ``tp_reduce_scatter`` calls it made)."""
    n, rs = [0], TH.tp_reduce_scatter

    def counted(*a, **kw):
        n[0] += 1
        return rs(*a, **kw)
    with mock.patch.object(TH, "tp_reduce_scatter", counted):
        return fn(), n[0]


def sp_pair(model, ap, ctx, mesh, toks, extra):
    """forward_lm's logits and states with SP forced on and off, and the
    reduce-scatters of the SP run."""
    tk = torch.as_tensor(toks).long()
    ex = {k: torch.as_tensor(a) for k, a in extra.items()}
    with torch.inference_mode():
        on, n = count_rs(lambda: TT.forward_lm(
            model, tk, ap, ctx, mesh, sp=True, collect_state=True, **ex))
        off = TT.forward_lm(model, tk, ap, ctx, mesh, sp=False,
                            collect_state=True, **ex)
    return on, off, n


def test_sequence_parallel_on_equals_off(whisper):
    """SP on (the encoder's residual cut on its 12 frames, the decoder's
    on the prompt: a reduce-scatter for the embedding, two for each
    encoder block and three for each decoder block) == SP off at 2 x 2
    within TOL, and at one pod (1 x 4) equal to the JAX SP forward.  (The
    reference's SP slices by the rank over every TP axis, the port's
    layout at one pod only: at 2 x 2 its forward does not trace; ROADMAP
    §3.)"""
    w = whisper
    tree4 = pad_vocab(w["tree"], 4)
    L, E = w["tcfg"].n_layers, w["tcfg"].enc_layers
    for pods in (2, 1):
        mesh, ctx = mesh_and_ctx(4, pods, ar_strategy="hier_rd",
                                 device="cpu")
        model = params_from_numpy(tree4, w["tcfg"], "cpu", mesh=mesh)
        ap = TT.make_plan(w["tcfg"], 4)
        (on, st), (off, st0), n = sp_pair(model, ap, ctx, mesh,
                                          w["toks"][:, :S], w["extra"])
        assert n == 1 + 2 * E + 3 * L
        np.testing.assert_allclose(on.numpy(), off.numpy(), atol=TOL, rtol=0)
        np.testing.assert_allclose(st["enc_k"].numpy(), st0["enc_k"].numpy(),
                                   atol=TOL, rtol=0)
        if pods == 1:
            jsp = jax_tp_forward(w["jcfg"], tree4, ctx, 1, 4, w["toks"][:, :S],
                                 w["extra"], sp=True)
            np.testing.assert_allclose(on.numpy(), jsp, atol=TOL, rtol=0)


def test_refusals(whisper):
    """What the reference refuses for the family, and what the port adds:
    the batcher (its requests carry no frames), trace mode (the
    reference's words), speculative decoding, the disaggregated prefill
    pool, the prefix cache, a generate without frames."""
    w = whisper
    ap, model = w["ap"], w["model"]
    with pytest.raises(ValueError, match="text-only"):
        ContinuousBatcher(ap, model, slots=2, s_max=S_MAX, device="cpu")
    with pytest.raises(SystemExit, match="trace mode supports text-only"):
        serve.main(["--arch", ARCH, "--mode", "trace", "--device", "cpu"])
    with pytest.raises(ValueError, match="dense families"):
        InferenceEngine(ap, model, s_max=S_MAX, spec_mode="ngram",
                        device="cpu")
    with pytest.raises(ValueError, match="dense families"):
        PrefillPool(ap, model, s_max=S_MAX, device="cpu")
    with pytest.raises(SpecError, match="dense"):
        ReplicaSpec(arch=ARCH, block_size=8, prefix_cache="on",
                    admit_mode="chunked", admit_chunk=8, s_max=64).validate()
    eng = InferenceEngine(ap, model, s_max=S_MAX, device="cpu")
    with pytest.raises(ValueError, match="frame_embeds"):
        eng.generate(w["toks"][:, :S], NEW)
    with pytest.raises(ValueError, match="shape"):
        eng.generate(w["toks"][:, :S], NEW, extra={
            "frame_embeds": w["extra"]["frame_embeds"][:, :5]})


def test_serve_cli_batch_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--mode", "batch", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--max-new", "4",
                      "--block-size", "8"])
    assert res.new_tokens.shape == (2, 4)
    assert "cross K/V (12 frames)" in capsys.readouterr().out
