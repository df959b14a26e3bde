"""The port's serving stack: the block allocator and the trace against the
JAX package's, the continuous batcher against the JAX batcher on bridged
weights, and the port's own bars (one request == generate, paged == dense,
preemption and defragmentation change no token, seeded sampling, the
other families, the virtual mesh, ``--mode trace``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.inference import kv_cache as JK  # noqa: E402
from repro.inference import scheduler as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.inference import kv_cache as TK  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.inference.scheduler import (  # noqa: E402
    ContinuousBatcher, Request, make_trace)
from repro_torch.kernels.rd_allreduce.ops import RDWorkspace  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.parallel.steps import CapturedStep  # noqa: E402

torch.set_num_threads(1)

SLOTS, S_MAX = 3, 64
# Greedy tokens are compared until the first step whose top-1/top-2 logit
# gap (teacher-forced over the reference's sequence) is within GAP_TOL:
# f32 sums in another order move O(1) logits by ~1e-6.
GAP_TOL = 1e-4


def _trace(vocab, n=6, seed=1, mean_out=6):
    return make_trace(n, mean_in=10, mean_out=mean_out, rate=0.6,
                      vocab=vocab, seed=seed)


def _copy(reqs):
    return [Request(r.rid, r.prompt, r.max_new, r.arrival_s) for r in reqs]


def _serve(ap, model, reqs, **kw):
    b = ContinuousBatcher(ap, model, **{"slots": SLOTS, "s_max": S_MAX,
                                        "device": "cpu", **kw})
    done = b.run(_copy(reqs))
    return {r.rid: r.output for r in done}, b


@pytest.fixture(scope="module")
def llama():
    """llama3.2 smoke in f32: the port's seeded model, and the JAX tree
    with its bridged copy."""
    jcfg = dataclasses.replace(jax_smoke("llama3.2-1b"), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype=torch.float32)
    jap, tap = JT.make_plan(jcfg, 1), TT.make_plan(tcfg, 1)
    params = jax.jit(JT.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jap)
    bridged = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                "cpu")
    return dict(jap=jap, params=params, tap=tap, bridged=bridged,
                model=TT.init_params(tap, seed=0, device="cpu"))


def _gated_equal(ap, model, reqs, ours, ref, mesh_ctx=()):
    """Each request's tokens equal the reference's until the first step
    whose gap (the port's tp=1 forward over the reference's sequence) is
    within GAP_TOL; returns the steps checked."""
    checked = 0
    for r in reqs:
        seq = np.concatenate([r.prompt, ref[r.rid]])
        with torch.inference_mode():
            lg, _ = TT.forward_lm(model, torch.as_tensor(seq[None, :-1]),
                                  ap, *mesh_ctx)
        top2 = torch.topk(lg[0, len(r.prompt) - 1:].float(), 2).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        for t in range(len(ref[r.rid])):
            if gap[t] <= GAP_TOL:
                break
            assert ours[r.rid][t] == ref[r.rid][t], (r.rid, t, gap[t])
            checked += 1
    return checked


def test_captured_step_captures_anew_when_the_workspace_moves(monkeypatch):
    """``CapturedStep``: eager first call, captured on the second, replays
    after; when the workspace's generation has moved since the capture it
    captures anew before replaying, and ``graph=False`` stays eager.  The
    CUDA graph is simulated: its capture records the body, its replay
    runs it."""
    class Graph:
        def replay(self):
            self.fn()

    class Capture:
        def __init__(self, g):
            self.g = g

        def __enter__(self):
            runs.append("capture")

        def __exit__(self, *exc):
            self.g.fn = body
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    runs = []

    def body():
        if runs and runs[-1] == "capture":
            runs[-1] = "captured"     # recorded by the capture, not run
        else:
            runs.append("run")

    ws = RDWorkspace()
    step = CapturedStep(body, True, workspace=ws)
    step()
    step()
    step()
    ws.generation += 1
    step()
    step()
    assert runs == ["run", "captured", "run", "run", "captured", "run",
                    "run"]
    assert (step.calls, step.replays, step.recaptures) == (5, 4, 1)
    runs.clear()
    eager = CapturedStep(body, False, workspace=ws)
    for _ in range(3):
        eager()
    assert runs == ["run"] * 3 and eager.replays == 0


def test_block_allocator_matches_jax():
    """A seeded random sequence of ensure / note_usage / free / preempt /
    defragment on both allocators: tables, versions, free counts, stats
    and permutations equal after every operation, and ``check()``."""
    rng = np.random.default_rng(0)
    args = (14, 4, 3, 6)
    ours, ref = TK.BlockAllocator(*args), JK.BlockAllocator(*args)
    assert TK.paged_geometry(24, 4) == JK.paged_geometry(24, 4) == 6
    for _ in range(300):
        op, slot = rng.integers(0, 5), int(rng.integers(0, 3))
        if op <= 1:
            n = int(rng.integers(1, 25))
            ok = ours.ensure(slot, n)
            assert ok == ref.ensure(slot, n)
            if ok:
                ours.note_usage(slot, n)
                ref.note_usage(slot, n)
        elif op == 2:
            assert ours.free(slot) == ref.free(slot)
        elif op == 3:
            assert ours.preempt(slot) == ref.preempt(slot)
        else:
            a, b = ours.defragment(), ref.defragment()
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.table, ref.table)
        assert ours.version == ref.version
        assert ours.free_blocks == ref.free_blocks
        assert dataclasses.asdict(ours.stats()) == \
            dataclasses.asdict(ref.stats())
        ours.check()


def test_make_trace_matches_jax():
    kw = dict(mean_in=24, mean_out=12, rate=0.7, vocab=97, seed=5)
    ours, ref = make_trace(9, **kw), JS.make_trace(9, **kw)
    for a, b in zip(ours, ref, strict=True):
        assert (a.rid, a.max_new, a.arrival_s) == \
            (b.rid, b.max_new, b.arrival_s)
        np.testing.assert_array_equal(a.prompt, b.prompt)


@pytest.mark.parametrize("block_size", [0, 8], ids=["dense", "paged"])
def test_batcher_matches_jax_batcher(llama, block_size):
    """One trace through the JAX batcher and the port's, same weights:
    greedy tokens gated by the gap, and the counting fields of the
    metrics equal."""
    reqs = _trace(llama["tap"].cfg.vocab_size)
    jb = JS.ContinuousBatcher(llama["jap"], llama["params"], slots=SLOTS,
                              s_max=S_MAX, block_size=block_size)
    jdone = jb.run(JS.make_trace(6, mean_in=10, mean_out=6, rate=0.6,
                                 vocab=llama["tap"].cfg.vocab_size, seed=1))
    ref = {r.rid: np.asarray(r.output) for r in jdone}
    b = ContinuousBatcher(llama["tap"], llama["bridged"], slots=SLOTS,
                          s_max=S_MAX, block_size=block_size, device="cpu")
    done = b.run(reqs)
    ours = {r.rid: r.output for r in done}
    assert _gated_equal(llama["tap"], llama["bridged"], reqs, ours,
                        ref) >= len(reqs)
    jm, m = jb.metrics(jdone), b.metrics(done)
    for f in ("completed", "steps", "preemptions", "total_new_tokens"):
        assert getattr(m, f) == getattr(jm, f), f


def test_one_request_equals_generate(llama):
    """One request through a one-slot batcher is bitwise the engine's
    generate of its prompt."""
    r = _trace(llama["tap"].cfg.vocab_size, n=1, mean_out=9)[0]
    ours, _ = _serve(llama["tap"], llama["model"], [r], slots=1)
    ref = InferenceEngine(llama["tap"], llama["model"], s_max=S_MAX,
                          device="cpu").generate(r.prompt[None], r.max_new)
    np.testing.assert_array_equal(ours[r.rid], ref.new_tokens[0])


def test_paged_trace_equals_dense_and_defrag_changes_nothing(llama):
    """Paged == dense bitwise; defragmenting the pool after every step
    changes no token."""
    ap, model = llama["tap"], llama["model"]
    reqs = _trace(ap.cfg.vocab_size, n=7, seed=2)
    dense, _ = _serve(ap, model, reqs)
    paged, b = _serve(ap, model, reqs, block_size=8)
    for rid, toks in dense.items():
        np.testing.assert_array_equal(paged[rid], toks)
    assert b.alloc.used_blocks == 0
    b = ContinuousBatcher(ap, model, slots=SLOTS, s_max=S_MAX, block_size=8,
                          device="cpu")
    step = b.step

    def step_and_defrag(now):
        step(now)
        b.defragment()
    b.step = step_and_defrag
    done = b.run(_copy(reqs))
    assert b.alloc.defrags > 0
    for r in done:
        np.testing.assert_array_equal(r.output, dense[r.rid])


def test_preemption_resumes_exact(llama):
    """A pool too small for the trace (13 blocks of 8) preempts and
    recomputes; every request's tokens equal the undisturbed run's, and
    the pool is empty at drain."""
    ap, model = llama["tap"], llama["model"]
    reqs = make_trace(6, mean_in=20, mean_out=14, rate=2.0,
                      vocab=ap.cfg.vocab_size, seed=3)
    full, _ = _serve(ap, model, reqs, slots=4)
    small, b = _serve(ap, model, reqs, slots=4, block_size=8, n_blocks=13)
    m = b.metrics(reqs)
    assert m.preemptions > 0 and m.wasted_tokens > 0
    for rid, toks in full.items():
        np.testing.assert_array_equal(small[rid], toks)
    assert b.alloc.used_blocks == 0
    b.alloc.check()


def test_sampled_serving_is_seeded(llama):
    """temperature > 0: each request's stream is a function of (seed, rid)
    alone: the same under another slot count and the paged cache,
    another under another seed."""
    ap, model = llama["tap"], llama["model"]
    reqs = _trace(ap.cfg.vocab_size, seed=4)
    kw = dict(temperature=1.0, top_k=8)
    a, _ = _serve(ap, model, reqs, seed=3, **kw)
    b, _ = _serve(ap, model, reqs, seed=3, slots=2, block_size=8, **kw)
    c, _ = _serve(ap, model, reqs, seed=4, **kw)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])
    assert any(not np.array_equal(a[rid], c[rid]) for rid in a)
    assert max(int(t.max()) for t in a.values()) < ap.cfg.vocab_size


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b",
                                  "qwen3-moe-30b-a3b"])
def test_other_families_equal_generate(arch):
    """A short trace through full admission: each request's tokens are its
    own batch-1 generate's (recurrent leaves, the hybrid's K/V and mamba
    state, the MoE layers spliced into their slot)."""
    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32)
    ap = TT.make_plan(cfg, 1)
    model = TT.init_params(ap, seed=1, device="cpu")
    reqs = make_trace(4, mean_in=8, mean_out=5, rate=1.0,
                      vocab=cfg.vocab_size, seed=6)
    ours, _ = _serve(ap, model, reqs, slots=2, s_max=32,
                     block_size=0 if cfg.attn_free else 8)
    eng = InferenceEngine(ap, model, s_max=32, device="cpu")
    for r in reqs:
        ref = eng.generate(r.prompt[None], r.max_new).new_tokens[0]
        np.testing.assert_array_equal(ours[r.rid], ref)


@pytest.fixture(scope="module")
def mesh_case(llama):
    """The seeded llama smoke model at tp=4 on a 2 x 2 virtual mesh (one
    function at every tp) beside its tp=1 copy."""
    mesh, ctx = mesh_and_ctx(4, 2, ar_strategy="hier_rd", device="cpu")
    ap = TT.make_plan(llama["tap"].cfg, 4)
    return ap, TT.init_params(ap, seed=0, device="cpu", mesh=mesh), \
        dict(ctx=ctx, mesh=mesh)


def test_mesh_batcher_matches_tp1_and_pages_bitwise(llama, mesh_case):
    ap, model, kw = mesh_case
    reqs = _trace(ap.cfg.vocab_size, seed=7)
    tp1, _ = _serve(llama["tap"], llama["model"], reqs)
    dense, _ = _serve(ap, model, reqs, **kw)
    paged, b = _serve(ap, model, reqs, block_size=8, **kw)
    assert b.cache["k"].shape[1] == 4 * b.n_blocks
    for rid, toks in dense.items():
        np.testing.assert_array_equal(paged[rid], toks)
    assert _gated_equal(llama["tap"], llama["model"], reqs, dense,
                        tp1) >= len(reqs)


def test_mesh_sampling_is_seeded(mesh_case):
    ap, model, kw = mesh_case
    reqs = _trace(ap.cfg.vocab_size, seed=8)
    s = dict(temperature=1.0, top_k=8, block_size=8, **kw)
    a, _ = _serve(ap, model, reqs, seed=3, **s)
    b, _ = _serve(ap, model, reqs, seed=3, **s)
    c, _ = _serve(ap, model, reqs, seed=5, **s)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])
    assert any(not np.array_equal(a[rid], c[rid]) for rid in a)


@pytest.mark.parametrize("extra", [[], ["--tp", "4", "--pods", "2",
                                        "--block-size", "16",
                                        "--ar-strategy", "hier_rd"]],
                         ids=["tp1", "tp4_paged"])
def test_serve_cli_trace_on_cpu(capsys, tmp_path, extra):
    out = tmp_path / "m.json"
    done, m = serve.main(["--mode", "trace", "--device", "cpu",
                          "--n-requests", "5", "--json-out", str(out)]
                         + extra)
    assert m.completed == m.requests == 5 and all(r.output is not None
                                                  for r in done)
    line = capsys.readouterr().out
    assert "[serve] trace llama3.2-smoke on cpu" in line and "TTFT" in line
    assert ("paged(bs=16) tp=4 (2x2) ar=hier_rd" in line) == bool(extra)
    assert '"total_new_tokens"' in out.read_text()


@pytest.mark.parametrize("knob,item", [
    (dict(admit_mode="chunked"), "item 6b"),
    (dict(spec_mode="ngram"), "item 7"),
    (dict(prefix_cache="on"), "item 7"),
    (dict(deadline_s=4.0), "item 7"),
    (dict(kv_quant=True), "item 9"),
], ids=["chunked", "spec", "prefix", "deadline", "kv_quant"])
def test_batcher_knobs_left_for_later_raise(llama, knob, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ContinuousBatcher(llama["tap"], llama["model"], device="cpu", **knob)
