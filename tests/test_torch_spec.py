"""Speculative decoding in the port: the host-side pieces (drafters,
``AdaptiveK``, ``BlockAllocator.truncate``, the prefix trie) as the
reference's unit tests check them, run on both packages through one
parametrised test each; then the verify path: spec greedy == plain on the
batcher (dense, paged, a 2 x 2 mesh) and on the engine, the replay drafter
cutting steps, preemption with rollback keeping exact tokens, the
acceptance-collapse degrade, and sampled spec repeating under its seed."""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.inference.scheduler import (  # noqa: E402
    ContinuousBatcher, Request, make_trace)
from repro_torch.inference.speculative import (  # noqa: E402
    Drafter, ReplayDrafter)
from repro_torch.kernels import flash_attention_chunk  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

torch.set_num_threads(1)

SLOTS, S_MAX = 3, 64


def _pkg(name):
    """The host modules of one package: speculative, kv_cache,
    prefix_cache."""
    return tuple(importlib.import_module(f"{name}.inference.{m}")
                 for m in ("speculative", "kv_cache", "prefix_cache"))


PKGS = pytest.mark.parametrize("pkg", ["repro", "repro_torch"])


# ---------------------------------------------------------------------------
# host-side pieces, on both packages
# ---------------------------------------------------------------------------


@PKGS
def test_ngram_drafter(pkg):
    spec = _pkg(pkg)[0]
    d = spec.NGramDrafter(max_n=3)
    d.reset(0, [1, 2, 3, 9, 1, 2, 3])
    assert d.draft(0, 3).tolist() == [9, 1, 2] and d.hit_rate == 1.0
    d.reset(1, [5, 6, 7, 8])             # no recurring suffix: fallback
    assert d.draft(1, 2).tolist() == [8, 8]
    d.reset(2, [4])
    assert d.draft(2, 4).shape == (4,)
    d.reset(3, [2, 3, 7, 2, 3, 8, 2, 3])  # the most recent occurrence wins
    assert d.draft(3, 1).tolist() == [8]
    d.observe(3, [8, 2])
    assert d.draft(3, 2).tolist() == [3, 8]


@PKGS
def test_replay_drafter_and_factory(pkg):
    spec = _pkg(pkg)[0]
    prompt = (10, 11, 12)
    d = spec.ReplayDrafter({prompt: [1, 2, 3, 4, 5]})
    d.reset(0, list(prompt) + [1])
    assert d.draft(0, 3).tolist() == [2, 3, 4]
    d.observe(0, [2, 3])
    assert d.draft(0, 3).tolist() == [4, 5, 5]
    d.reset(1, [99, 98, 1])
    assert d.draft(1, 2).shape == (2,)
    assert isinstance(spec.make_drafter("ngram"), spec.NGramDrafter)
    assert isinstance(spec.make_drafter("replay"), spec.ReplayDrafter)
    with pytest.raises(ValueError):
        spec.make_drafter("not-a-mode")


def test_draft_factory_targets_the_card_unless_asked(monkeypatch):
    """``make_drafter("draft")`` puts its model where the rest of the port
    would: ``device=None`` is the card (an error without one), the CPU
    only when asked."""
    from repro_torch.inference import speculative as spec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.make_drafter("draft")
    d = spec.make_drafter("draft", device="cpu")
    assert isinstance(d, spec.ModelDrafter) and d.device.type == "cpu"
    assert d.model.embed["tok"].device.type == "cpu"


def test_draft_model_reads_a_larger_vocabulary_clamped():
    """The draft model is a smoke model whose vocabulary can be smaller
    than the target's: a history id past it reads as its last id (the
    reference's embedding gather clamps so), never out of bounds."""
    from repro_torch.inference import speculative as spec
    d = spec.make_drafter("draft", device="cpu")
    top = d.ap.cfg.vocab_size - 1
    hist = [5, 7, top + 1, 128255, 3]
    d.reset(0, hist)
    d.reset(1, [min(t, top) for t in hist])
    assert d.draft(0, 3).tolist() == d.draft(1, 3).tolist()


@PKGS
def test_adaptive_k_ladder(pkg):
    spec = _pkg(pkg)[0]
    ak = spec.AdaptiveK(ks=(2, 4, 8))
    assert ak.k == 2
    for _ in range(8):
        ak.update(ak.k, ak.k)
    assert ak.k == 8
    for _ in range(12):
        ak.update(0, ak.k)
    assert ak.k == 2
    with pytest.raises(ValueError):
        spec.AdaptiveK(ks=(0, 2))


@PKGS
def test_block_allocator_truncate(pkg):
    kv = _pkg(pkg)[1]
    a = kv.BlockAllocator(n_blocks=9, block_size=4, slots=2,
                          max_blocks_per_slot=4)
    assert a.ensure(0, 14)
    owned = list(a.owned(0))
    assert a.truncate(0, 6) == 2 and list(a.owned(0)) == owned[:2]
    assert (a.table[0, 2:] == kv.TRASH_BLOCK).all()
    a.check()
    assert a.ensure(1, 8)
    v = a.version
    assert a.truncate(0, 5) == 0 and a.version == v
    assert a.truncate(0, 0) == 2 and (a.table[0] == kv.TRASH_BLOCK).all()
    a.check()


def _trie(pkg, capacity=None):
    _, kv, pc = _pkg(pkg)
    a = kv.BlockAllocator(n_blocks=64, block_size=4, slots=2,
                          max_blocks_per_slot=8)
    return a, pc.PrefixCache(a, capacity=capacity)


def _publish(a, pc, tokens):
    n = len(tokens) // 4
    assert a.ensure(0, n * 4)
    blocks = list(a.owned(0))[:n]
    pc.insert(tokens, blocks)
    a.free(0)
    return blocks


@PKGS
def test_prefix_trie_match_insert_brute_force(pkg):
    """Seeded insert / match streams over a 2-token vocabulary against a
    dict of published group paths (first-published block kept)."""
    a, pc = _trie(pkg)
    rng = np.random.default_rng(7)
    model = {}
    for _ in range(30):
        toks = rng.integers(0, 2, int(rng.integers(4, 17))).tolist()
        if rng.random() < 0.5:
            blocks = _publish(a, pc, toks)
            groups = [tuple(toks[i * 4:(i + 1) * 4])
                      for i in range(len(toks) // 4)]
            for i, b in enumerate(blocks):
                model.setdefault(tuple(groups[:i + 1]), b)
        got = pc.match(toks)
        want = []
        groups = [tuple(toks[i * 4:(i + 1) * 4])
                  for i in range(len(toks) // 4)]
        for i in range(len(groups)):
            if tuple(groups[:i + 1]) not in model:
                break
            want.append(model[tuple(groups[:i + 1])])
        assert got == want
        a.check()


@PKGS
def test_prefix_trie_eviction_and_remap(pkg):
    """LRU never evicts a block a live slot maps; capacity evicts on
    insert; invalidate drops a subtree; defragment remaps every node."""
    a, pc = _trie(pkg)
    shared = [7] * 8
    blocks = _publish(a, pc, shared)
    a.share(1, blocks)
    _publish(a, pc, [200 + t for t in range(8)])
    assert pc.reclaim(10 ** 9) == 2 and pc.match(shared) == blocks
    a.free(1)
    assert pc.reclaim(10 ** 9) == 2 and pc.held_blocks == 0
    toks = list(range(12))
    b3 = _publish(a, pc, toks)
    assert pc.invalidate_block(b3[1]) == 2 and pc.match(toks) == b3[:1]
    assert a.ensure(1, 12)
    old = _publish(a, pc, [300 + t for t in range(8)])
    a.free(1)
    perm = a.defragment()
    new = pc.match([300 + t for t in range(8)])
    assert perm is not None and [int(perm[b]) for b in new] == old
    a.check()
    a2, pc2 = _trie(pkg, capacity=2)
    _publish(a2, pc2, [1 + t for t in range(8)])
    _publish(a2, pc2, [100 + t for t in range(8)])
    assert pc2.held_blocks == 2 and pc2.evictions == 2


# ---------------------------------------------------------------------------
# the verify path: spec == plain
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype=torch.float32)
    ap = TT.make_plan(cfg, 1)
    return cfg, ap, TT.init_params(ap, seed=0, device="cpu")


def _copy(reqs):
    return [Request(r.rid, r.prompt, r.max_new, r.arrival_s) for r in reqs]


def _serve(ap, model, reqs, **kw):
    b = ContinuousBatcher(ap, model, **{"slots": SLOTS, "s_max": S_MAX,
                                        "device": "cpu", **kw})
    done = b.run(_copy(reqs))
    return {r.rid: r.output for r in done}, b.metrics(done), b


def _same(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def _trace(vocab, **kw):
    return make_trace(8, mean_in=10, mean_out=8, rate=2.0, vocab=vocab,
                      seed=2, **kw)


@pytest.mark.parametrize("case", ["dense", "paged", "chunked_adaptive",
                                  "draft", "mesh2x2_paged"])
def test_batcher_spec_greedy_equals_plain(smoke, case):
    """Greedy spec tokens == plain greedy tokens: ngram drafts dense and
    paged, with chunked admission and the adaptive k, the seeded draft
    model, and on a 2 x 2 mesh; the verify path runs kernel 3's chunk
    form (its plain version on CPU tensors)."""
    cfg, ap, model = smoke
    kw, spec = {}, dict(spec_mode="ngram")
    if case == "paged":
        kw = dict(block_size=8)
    elif case == "chunked_adaptive":
        kw = dict(block_size=8, admit_mode="chunked", admit_chunk=16)
        spec.update(spec_k=8, spec_adaptive=True)
    elif case == "draft":
        spec = dict(spec_mode="draft")
    elif case == "mesh2x2_paged":
        mesh, ctx = mesh_and_ctx(4, 2, ar_strategy="hier_rd", device="cpu")
        ap = TT.make_plan(cfg, 4)
        model = TT.init_params(ap, seed=0, device="cpu", mesh=mesh)
        kw = dict(block_size=8, ctx=ctx, mesh=mesh)
    reqs = _trace(cfg.vocab_size)
    plain, _, _ = _serve(ap, model, reqs, **kw)
    got, m, _ = _serve(ap, model, reqs, **kw, **spec)
    assert _same(got, plain)
    assert m.spec_steps == m.steps > 0 and m.drafted_tokens > 0
    if case == "chunked_adaptive":
        assert m.spec_k_mean != 8.0


def test_replay_drafter_cuts_steps_and_preemption_rolls_back(smoke):
    """The replay drafter (the plain run's streams) is accepted almost
    always and cuts the steps; under a pool that preempts, the rejected
    tails' blocks are truncated and the tokens stay the plain run's."""
    cfg, ap, model = smoke
    reqs = _trace(cfg.vocab_size)
    plain, m0, _ = _serve(ap, model, reqs, block_size=8)
    streams = {tuple(int(t) for t in r.prompt): list(plain[r.rid])
               for r in reqs}
    got, m, b = _serve(ap, model, reqs, block_size=8, spec_mode="replay",
                       drafter=ReplayDrafter(streams))
    assert _same(got, plain)
    assert m.acceptance_rate > 0.9 and m.steps < m0.steps / 2
    tight, mt, bt = _serve(ap, model, reqs, block_size=8, n_blocks=9,
                           spec_mode="ngram")
    assert _same(tight, plain) and mt.preemptions > 0
    bt.alloc.check()


class _Wrong(Drafter):
    """Proposes a token the target never emits first: every pass rejects."""

    def _propose(self, slot, hist, k):
        return [(hist[-1] + 1) % 97] * k


def test_acceptance_collapse_degrades_to_plain(smoke):
    cfg, ap, model = smoke
    reqs = _trace(cfg.vocab_size)
    plain, _, _ = _serve(ap, model, reqs)
    got, m, _ = _serve(ap, model, reqs, spec_mode="ngram",
                       drafter=_Wrong(), spec_autodisable_after=2)
    assert _same(got, plain) and m.spec_autodisables > 0
    assert m.steps > m.spec_steps      # some steps fell back to plain decode


def test_sampled_spec_repeats_under_its_seed(smoke):
    cfg, ap, model = smoke
    reqs = _trace(cfg.vocab_size)
    kw = dict(spec_mode="ngram", temperature=1.0, top_k=8)
    a, _, _ = _serve(ap, model, reqs, seed=3, **kw)
    b, _, _ = _serve(ap, model, reqs, seed=3, block_size=8, **kw)
    c, _, _ = _serve(ap, model, reqs, seed=4, **kw)
    assert _same(a, b) and not _same(a, c)
    assert max(int(t.max()) for t in a.values()) < cfg.vocab_size


@pytest.mark.parametrize("tp", [1, 4], ids=["tp1", "mesh2x2"])
def test_engine_spec_generate_equals_plain(smoke, tp):
    cfg, ap, model = smoke
    kw = {}
    if tp > 1:
        mesh, ctx = mesh_and_ctx(4, 2, ar_strategy="hier_rd", device="cpu")
        ap = TT.make_plan(cfg, 4)
        model = TT.init_params(ap, seed=0, device="cpu", mesh=mesh)
        kw = dict(ctx=ctx, mesh=mesh)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 12))
    plain = InferenceEngine(ap, model, s_max=48, device="cpu",
                            **kw).generate(prompts, 10)
    before = flash_attention_chunk.launches
    eng = InferenceEngine(ap, model, s_max=48, device="cpu",
                          spec_mode="ngram", block_size=8, **kw)
    got = eng.generate(prompts, 10)
    assert flash_attention_chunk.launches == before     # CPU: plain version
    np.testing.assert_array_equal(got.tokens, plain.tokens)
    assert got.steps <= plain.steps
    with pytest.raises(ValueError, match="dense"):
        rcfg = dataclasses.replace(get_smoke("rwkv6-7b"),
                                   dtype=torch.float32)
        InferenceEngine(TT.make_plan(rcfg, 1), model, device="cpu",
                        spec_mode="ngram")
