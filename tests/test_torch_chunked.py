"""Kernel 3's chunk form and the chunked-prefill machinery of the port:
the chunk form's plain version against the JAX ``attn_core`` under the
mask of ``attention_chunk_step`` (dense rows and a paged table, offsets off
the 64-key tiles, GQA, a window), the port's ``prefill_chunk`` against the
JAX ``prefill_chunk`` on bridged f32 weights (logits and written K/V),
chunked admission == full admission at tp=1 and on a 2 x 2 mesh, dense and
paged, and the prefix cache on == off, bitwise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.pcontext import LOCAL as JLOCAL  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.inference.scheduler import (  # noqa: E402
    ContinuousBatcher, Request, make_prefix_trace, make_trace)
from repro_torch.kernels import flash_attention_chunk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

# f32 sums of O(1) terms in another order (einsum shapes, XLA vs ATen)
ATOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
SLOTS, S_MAX, CHUNK = 3, 64, 16


def _f32_smoke():
    return (dataclasses.replace(jax_smoke("llama3.2-1b"), dtype=jnp.float32),
            dataclasses.replace(get_smoke("llama3.2-1b"),
                                dtype=torch.float32))


# ---------------------------------------------------------------------------
# kernel 3's chunk form: the plain version against the JAX attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 24], ids=["causal", "window24"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["g1", "g4"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_chunk_form_matches_jax_attention(layout, hq, hkv, window):
    """Three sequences at offsets 5, 70 and 33 (none a multiple of 64), 9
    queries each, over a 128-position cache: the chunk wrapper on CPU
    tensors (its plain version) against ``attn_core`` under
    ``layers._mask(positions, arange(S_max))``, the keys each sequence
    reads gathered as ``attention_chunk_step`` gathers them.  The wrapper
    launches nothing on CPU tensors."""
    rng = np.random.default_rng(hq + 10 * window + (layout == "paged"))
    N, C, hd, s_max, bs = 3, 9, 16, 128, 16
    offs = np.array([5, 70, 33], np.int32)
    q = rng.standard_normal((N, C, hq, hd)).astype(np.float32)
    kv = rng.standard_normal((2, 5, s_max, hkv, hd)).astype(np.float32)
    rows = np.array([3, 0, 4], np.int32)
    k_att, v_att = kv[0][rows], kv[1][rows]            # (N, S_max, U, hd)
    if layout == "dense":
        cache = [torch.as_tensor(x) for x in kv]
        kw = {"rows": torch.as_tensor(rows)}
    else:
        mb = s_max // bs
        nb = N * mb + 1
        tbl = (1 + rng.permutation(nb - 1)).astype(np.int32).reshape(N, mb)
        pools = [np.full((nb, bs, hkv, hd), 7.0, np.float32) for _ in kv]
        for pool, att in zip(pools, (k_att, v_att)):
            pool[tbl.reshape(-1)] = att.reshape(N * mb, bs, hkv, hd)
        cache = [torch.as_tensor(x) for x in pools]
        kw = {"block_tbl": torch.as_tensor(tbl)}
    positions = offs[:, None] + np.arange(C, dtype=np.int32)
    mask = JL._mask(jnp.asarray(positions), jnp.arange(s_max), causal=True,
                    window=window)
    want = np.asarray(JL.attn_core(jnp.asarray(q), jnp.asarray(k_att),
                                   jnp.asarray(v_att), mask, hq // hkv))
    before = flash_attention_chunk.launches
    got = flash_attention_chunk(torch.as_tensor(q).transpose(1, 2),
                                *cache, torch.as_tensor(offs),
                                window=window, **kw).transpose(1, 2)
    assert flash_attention_chunk.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def test_chunk_form_takes_rows_or_table():
    q = torch.zeros(1, 2, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    off = torch.zeros(1, dtype=torch.int32)
    for kw in ({}, {"rows": off, "block_tbl": off[None]}):
        with pytest.raises(ValueError, match="rows"):
            flash_attention_chunk(q, k, k, off, **kw)


# ---------------------------------------------------------------------------
# prefill_chunk against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama():
    """f32 llama3.2 smoke: the JAX tree, its bridged copy, the plans, and
    the JAX prefill_chunk compiled once a layout (slot and batch-wide)."""
    jcfg, tcfg = _f32_smoke()
    jap, tap = JT.make_plan(jcfg, 1), TT.make_plan(tcfg, 1)
    params = jax.jit(JT.init_params, static_argnums=1,
                     compiler_options=FAST_COMPILE)(jax.random.PRNGKey(0),
                                                    jap)
    bridged = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")

    def chunk_fn(slot):
        return jax.jit(lambda p, c, t, q, s: JT.prefill_chunk(
            p, c, t, q, jap, JLOCAL, slot=s if slot else None),
            compiler_options=FAST_COMPILE)

    return dict(jap=jap, tap=tap, params=params, bridged=bridged,
                slot_fn=chunk_fn(True), batch_fn=chunk_fn(False),
                model=TT.init_params(tap, seed=0, device="cpu"))


@pytest.mark.parametrize("block_size", [0, 8], ids=["dense", "paged"])
def test_prefill_chunk_matches_jax(llama, block_size):
    """Three chunks of 8 spliced into slot 1 of a 3-row cache, then one
    batch-wide chunk at ragged offsets (the verify step's form): the
    port's logits and every layer's written K/V within ATOL of the JAX
    package's, the EF-free cache otherwise untouched."""
    jap, tap = llama["jap"], llama["tap"]
    jc = JT.init_cache(jap, SLOTS, S_MAX, block_size=block_size)
    tc = TT.init_cache(tap, SLOTS, S_MAX, block_size=block_size,
                       device="cpu")
    rng = np.random.default_rng(block_size)
    vocab = jap.cfg.vocab_size
    C = 8
    calls = [(rng.integers(0, vocab, (1, C)),
              (np.arange(C) + i * C)[None], 1) for i in range(3)]
    starts = np.array([3, 24, 11])
    calls.append((rng.integers(0, vocab, (SLOTS, C)),
                  starts[:, None] + np.arange(C), None))
    for toks, pos, slot in calls:
        toks, pos = toks.astype(np.int32), pos.astype(np.int32)
        if slot is None:
            jl, jc = llama["batch_fn"](llama["params"], jc, toks, pos, 0)
            tl, tc = TT.prefill_chunk(llama["bridged"], tc,
                                      torch.as_tensor(toks),
                                      torch.as_tensor(pos), tap)
        else:
            jl, jc = llama["slot_fn"](llama["params"], jc, toks, pos,
                                      jnp.int32(slot))
            tl, tc = TT.prefill_chunk(llama["bridged"], tc,
                                      torch.as_tensor(toks),
                                      torch.as_tensor(pos), tap,
                                      slot=torch.tensor([slot]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       atol=ATOL, rtol=ATOL)
    if block_size:
        np.testing.assert_array_equal(tc["block_tbl"].numpy(),
                                      np.asarray(jc["block_tbl"]))


def test_prefill_chunk_refusals(llama):
    """The reference's refusals: a non-dense family, and an intermediate
    chunk asked for no logits returns None."""
    cfg = dataclasses.replace(get_smoke("rwkv6-7b"), dtype=torch.float32)
    ap = TT.make_plan(cfg, 1)
    with pytest.raises(ValueError, match="dense"):
        TT.prefill_chunk(None, {}, torch.zeros(1, 4, dtype=torch.int64),
                         torch.zeros(1, 4, dtype=torch.int32), ap)
    tc = TT.init_cache(llama["tap"], SLOTS, S_MAX, device="cpu")
    lg, _ = TT.prefill_chunk(llama["model"], tc,
                             torch.zeros(1, 4, dtype=torch.int64),
                             torch.arange(4, dtype=torch.int32)[None],
                             llama["tap"], slot=torch.tensor([2]),
                             return_logits=False)
    assert lg is None and tc["k"][:, 2, :4].abs().sum() > 0


# ---------------------------------------------------------------------------
# the batcher: chunked == full, prefix on == off
# ---------------------------------------------------------------------------


def _copy(reqs):
    return [Request(r.rid, r.prompt, r.max_new, r.arrival_s) for r in reqs]


def _serve(ap, model, reqs, **kw):
    b = ContinuousBatcher(ap, model, **{"slots": SLOTS, "s_max": S_MAX,
                                        "device": "cpu", **kw})
    done = b.run(_copy(reqs))
    return {r.rid: r.output for r in done}, b


def _same(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


@pytest.mark.parametrize("block_size", [0, 8], ids=["dense", "paged"])
@pytest.mark.parametrize("tp", [1, 4], ids=["tp1", "mesh2x2"])
def test_chunked_admission_equals_full(tp, block_size):
    """Chunked admission (8-token chunks: prompts of one and two chunks,
    a final chunk of pads included) gives full admission's tokens, f32, at tp=1 and on a
    2 x 2 mesh under hier_rd; its one captured-form chunk step serves
    every prompt length."""
    _, cfg = _f32_smoke()
    mesh, ctx = mesh_and_ctx(tp, 2, ar_strategy="hier_rd", device="cpu") \
        if tp > 1 else (None, TT.LOCAL)
    ap = TT.make_plan(cfg, tp)
    model = TT.init_params(ap, seed=0, device="cpu", mesh=mesh)
    reqs = make_trace(6, mean_in=20, mean_out=6, rate=0.6,
                      vocab=cfg.vocab_size, seed=3)
    assert len({-(-len(r.prompt) // 8) for r in reqs}) > 1
    kw = dict(ctx=ctx, mesh=mesh, block_size=block_size)
    full, _ = _serve(ap, model, reqs, **kw)
    chunked, b = _serve(ap, model, reqs, admit_mode="chunked",
                        admit_chunk=8, **kw)
    assert _same(chunked, full)
    mid, final = b._chunk_steps
    assert final.calls == len(reqs) and mid.calls > 0


@pytest.mark.parametrize("pool", ["full", "tight"])
def test_prefix_cache_on_equals_off(pool):
    """A shared-prefix trace (24 of 32 prompt tokens shared by 3/4 of the
    requests): prefix on == off, both chunked, bitwise, with hits and
    tokens saved; a tight pool (reclaim, then preemption) and a
    defragment after every step change no token."""
    _, cfg = _f32_smoke()
    ap = TT.make_plan(cfg, 1)
    model = TT.init_params(ap, seed=0, device="cpu")
    reqs = make_prefix_trace(8, prefix_len=24, shared_frac=0.75, mean_in=10,
                             mean_out=6, rate=0.8, vocab=cfg.vocab_size,
                             seed=4, clip_len=S_MAX - 1)
    kw = dict(block_size=8, admit_mode="chunked", admit_chunk=CHUNK,
              n_blocks=13 if pool == "tight" else None)
    off, _ = _serve(ap, model, reqs, **kw)
    b = ContinuousBatcher(ap, model, slots=SLOTS, s_max=S_MAX, device="cpu",
                          prefix_cache="on", **kw)
    step = b.step

    def step_then_defrag(now):
        step(now)
        b.defragment()

    b.step = step_then_defrag
    done = b.run(_copy(reqs))
    m = b.metrics(done)
    assert _same({r.rid: r.output for r in done}, off)
    assert m.prefix_hits > 0 and m.prefix_tokens_saved > 0
    assert m.prefix_lookups >= len(reqs) + m.preemptions
    if pool == "tight":
        assert m.preemptions > 0 or b.prefix.evictions > 0
    b.alloc.check()


def test_serve_cli_chunked_prefix_on_cpu(capsys):
    done, m = serve.main(["--mode", "trace", "--device", "cpu",
                          "--n-requests", "6", "--block-size", "8",
                          "--admit-mode", "chunked", "--admit-chunk", "16",
                          "--prefix-cache", "on", "--prefix-len", "16"])
    assert m.completed == 6 and m.prefix_hits > 0
    out = capsys.readouterr().out
    assert "chunked(16)+prefix" in out and "prefix cache:" in out
