"""The port's fault injection and the batcher's recovery: the fault model
against the JAX package's (``hash_unit``, the plan's parsing and errors,
the event sets at several rates, the bundle damage), and the bars on the
f32 llama smoke model at tp=1 and on a 2 x 2 mesh: every non-shed greedy
request's tokens bitwise the fault-free run's under each fault kind, shed
requests reported, schedules that replay; the scrub's need on the plain
attention versions; every cache write in place (what a captured step
holds); and one trace through the JAX batcher under the same plan on the
same weights."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.inference import faults as JF  # noqa: E402
from repro.inference import kv_cache as JK  # noqa: E402
from repro.inference import scheduler as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.inference import faults as TF  # noqa: E402
from repro_torch.inference import kv_cache as TK  # noqa: E402
from repro_torch.inference.scheduler import Request, make_trace  # noqa
from repro_torch.inference.spec import ReplicaSpec, build_replica  # noqa
from repro_torch.inference.speculative import Drafter  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

RS = ReplicaSpec(arch="llama3.2-1b", slots=3, s_max=64, block_size=8)
# f32 sums in another order move O(1) logits by ~1e-6: the JAX tokens may
# part from the port's only at a step whose top-1/top-2 gap is within this
GAP_TOL = 1e-4


@pytest.fixture(scope="module")
def lm():
    """llama3.2 smoke in f32: the port's seeded model at tp=1 and on a
    2 x 2 mesh's plan."""
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype=torch.float32)
    ap = TT.make_plan(cfg, 1)
    return dict(cfg=cfg, ap=ap,
                model=TT.init_params(ap, seed=0, device="cpu"))


def _trace(vocab, n=8, seed=4, mean_out=6, rate=3.0):
    return make_trace(n, mean_in=10, mean_out=mean_out, rate=rate,
                      vocab=vocab, seed=seed)


def _serve(lm, reqs, injector=None, drafter=None, spec=RS, **kw):
    sched = build_replica(spec.replace(**kw), ap=lm["ap"], model=lm["model"],
                          injector=injector, drafter=drafter, device="cpu")
    done = sched.run(reqs)
    return {r.rid: r.output for r in done}, sched


def _inj(**plan):
    return TF.FaultInjector(TF.FaultPlan(**plan))


# ---------------------------------------------------------------------------
# the fault model against the JAX package's
# ---------------------------------------------------------------------------


def test_hash_unit_equals_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        seed, a, b = (int(x) for x in rng.integers(0, 10**6, 3))
        for kind in TF.FAULT_KINDS:
            assert TF.hash_unit(seed, kind, a, b) == \
                JF.hash_unit(seed, kind, a, b)
    assert TF.FAULT_KINDS == JF.FAULT_KINDS


def _events(inj, n=300):
    """Every hook's fired ids over a fixed id range."""
    return {
        "drop": {(r, a) for r in range(n // 10) for a in range(4)
                 if inj.drop_handoff(r, a)},
        "corrupt": {(r, p) for r in range(n // 10) for p in range(3)
                    if inj.corrupt_handoff(r, p)},
        "pstall": {s for s in range(n) if inj.prefill_stalled(s)},
        "dstall": {s for s in range(n) if inj.decode_stalled(s)},
        "straggle": {s for s in range(n) if inj.straggle(s) >= 0},
        "nan": {(r, e) for r in range(n // 10) for e in range(8)
                if inj.poison_slot(r, e)},
        "oom": {s for s in range(n) if inj.oom_burst(s)}}


def test_event_sets_equal_reference_and_nest_across_rates():
    """At each rate the port's injector fires on the reference's events
    (and counts them alike), and a lower rate's events are a subset of a
    higher rate's."""
    prev = None
    for rate in (0.02, 0.1, 0.3, 0.7):
        plan = dict(seed=11, handoff_drop=rate, handoff_corrupt=rate,
                    prefill_stall=rate, decode_stall=rate, straggler=rate,
                    nan_logits=rate, oom=rate, stall_steps=3)
        ti, ji = _inj(**plan), JF.FaultInjector(JF.FaultPlan(**plan))
        ours, ref = _events(ti), _events(ji)
        assert ours == ref and ti.stats() == ji.stats()
        if prev is not None:
            assert all(prev[k] <= ours[k] for k in ours)
        prev = ours


def test_nan_fires_once_a_progress_key():
    inj = _inj(seed=3, nan_logits=1.0)
    assert inj.poison_slot(5, 2) and not inj.poison_slot(5, 2)
    assert inj.poison_slot(5, 3) and inj.counts["nan_logits"] == 2
    inj.reset_stats()
    assert inj.poison_slot(5, 2)       # a reset replays the schedule


@pytest.mark.parametrize("spec", [
    "nan_logits=1.5", "oom=-0.1", "stall_steps=0", "seed=1,bogus=2",
    "handoff_drop", "json-list", "json-rate"])
def test_fault_plan_parse_refuses_as_the_reference(tmp_path, spec):
    if spec.startswith("json-"):
        f = tmp_path / "plan.json"
        f.write_text(json.dumps([1, 2] if spec == "json-list"
                                else {"seed": 1, "straggler": 1.5}))
        spec = str(f)
    with pytest.raises(ValueError) as ref:
        JF.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as ours:
        TF.FaultPlan.parse(spec)
    assert str(ours.value) == str(ref.value)


def test_fault_plan_parses_strings_and_files_as_the_reference(tmp_path):
    s = "seed=7, handoff_drop=0.1,nan_logits=0.02,stall_steps=4,oom=1"
    f = tmp_path / "plan.json"
    f.write_text(json.dumps({"seed": 3, "straggler": 0.5,
                             "straggler_s": 0.01}))
    for spec in (s, str(f)):
        ours, ref = TF.FaultPlan.parse(spec), JF.FaultPlan.parse(spec)
        assert ours.to_dict() == ref.to_dict()
        assert ours.any_faults == ref.any_faults
    assert not TF.FaultPlan().any_faults


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corrupt_bundle_equals_reference(dtype):
    """The in-flight damage flips the same element to the same value as the
    reference's, in the bundle's dtype (bf16 held as its bits), the
    checksums before it are the reference's, and verify catches it."""
    rng = np.random.default_rng(1)
    k = rng.standard_normal((2, 5, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, 5, 2, 4)).astype(np.float32)
    jk, jv = jnp.asarray(k, dtype), jnp.asarray(v, dtype)
    ref = JK.KVBundle(k=np.asarray(jk), v=np.asarray(jv)).seal()
    tk, _ = TK.to_host(torch.from_numpy(k).to(getattr(torch, dtype)))
    tv, _ = TK.to_host(torch.from_numpy(v).to(getattr(torch, dtype)))
    ours = TK.KVBundle(k=tk, v=tv, dtype=dtype).seal()
    assert ours.checksum == ref.checksum
    JF.FaultInjector.corrupt_bundle(ref)
    TF.FaultInjector.corrupt_bundle(ours)
    assert np.asarray(ref.k).tobytes() == ours.k.tobytes()
    with pytest.raises(TK.BundleIntegrityError, match="checksum"):
        ours.verify()
    assert tk.tobytes() != ours.k.tobytes()     # the payload was copied


# ---------------------------------------------------------------------------
# the bars: survivors bitwise, shed requests reported, replays identical
# ---------------------------------------------------------------------------


FAULTS = {
    "nan": (dict(seed=7, nan_logits=0.15), {}),
    "oom": (dict(seed=9, oom=0.5), dict(mean_out=14)),
    "straggler": (dict(seed=4, straggler=0.3), {}),
    "nan_dense": (dict(seed=7, nan_logits=0.15), dict(block_size=0)),
    "nan_spec": (dict(seed=8, nan_logits=0.1),
                 dict(spec_mode="ngram", spec_k=3, mean_out=10)),
}


@pytest.mark.parametrize("kind", list(FAULTS))
def test_survivors_bitwise_the_fault_free_run(lm, kind):
    """Each fault kind at tp=1 (paged unless named dense): every request
    completes with the fault-free run's tokens, the kind's counter moves,
    one quarantine a NaN injection, and no NaN is left in the cache."""
    plan, kw = FAULTS[kind]
    mean_out = kw.pop("mean_out", 6)
    reqs = lambda: _trace(lm["cfg"].vocab_size, mean_out=mean_out)  # noqa
    ref, _ = _serve(lm, reqs(), **{k: v for k, v in kw.items()
                                   if k == "block_size"})
    inj = _inj(**plan)
    got, sched = _serve(lm, reqs(), injector=inj, **kw)
    m = sched.metrics([])                 # the counters
    for rid in ref:
        np.testing.assert_array_equal(ref[rid], got[rid])
    if "nan_logits" in plan:
        assert m.quarantines > 0
        assert m.quarantines == inj.counts["nan_logits"]
        assert m.wasted_tokens > 0
        assert torch.isfinite(sched.cache["k"]).all()
        assert torch.isfinite(sched.cache["v"]).all()
        if "spec_mode" in kw:
            assert m.spec_autodisables > 0
    if "oom" in plan:
        assert m.injected_oom > 0
    if "straggler" in plan:
        assert m.straggler_steps > 0 == m.quarantines


def test_mesh_survivors_bitwise_the_fault_free_run(lm):
    """On a 2 x 2 mesh (hier_rd, paged, one pool a rank): NaN into every
    rank's copy, OOM bursts; survivors bitwise the fault-free mesh run."""
    spec = RS.replace(tp=4, pods=2, ar_strategy="hier_rd")
    ap4 = TT.make_plan(lm["cfg"], 4)
    from repro_torch.core.mesh import mesh_and_ctx
    mesh, _ = mesh_and_ctx(4, 2, device="cpu")
    model4 = TT.init_params(ap4, seed=0, device="cpu", mesh=mesh)

    def run(injector=None):
        sched = build_replica(spec, ap=ap4, model=model4, injector=injector,
                              device="cpu")
        done = sched.run(_trace(lm["cfg"].vocab_size, mean_out=10))
        return {r.rid: r.output for r in done}, sched

    ref, _ = run()
    inj = _inj(seed=7, nan_logits=0.15, oom=0.3)
    got, sched = run(inj)
    m = sched.metrics([])
    assert m.quarantines > 0 and m.injected_oom > 0
    for rid in ref:
        np.testing.assert_array_equal(ref[rid], got[rid])
    assert torch.isfinite(sched.cache["k"]).all()


def test_colocated_deadline_sheds_and_reports(lm):
    """One slot, bursty arrivals and a 10-step deadline: late requests are
    shed with their reason, the rest keep the no-deadline tokens."""
    vocab = lm["cfg"].vocab_size
    ref, _ = _serve(lm, _trace(vocab, rate=10.0), slots=1)
    reqs = _trace(vocab, rate=10.0)
    got, sched = _serve(lm, reqs, slots=1, deadline_ms=10.0)
    m = sched.metrics(reqs)
    assert m.shed_requests > 0
    assert m.shed_requests + m.completed == len(reqs)
    for r in reqs:
        if r.output is None:
            assert r.shed_reason == "deadline" and r.shed_step >= 0
        else:
            np.testing.assert_array_equal(ref[r.rid], r.output)


class _AlwaysWrongDrafter(Drafter):
    def _propose(self, slot, hist, k):
        return [(hist[-1] + 17 + i) % 50 for i in range(k)]


def test_spec_acceptance_collapse_autodisables(lm):
    vocab = lm["cfg"].vocab_size
    ref, _ = _serve(lm, _trace(vocab, mean_out=12))
    got, sched = _serve(lm, _trace(vocab, mean_out=12), spec_mode="ngram",
                        spec_k=3, drafter=_AlwaysWrongDrafter(),
                        spec_autodisable_after=2)
    assert sched.metrics([]).spec_autodisables > 0
    for rid in ref:
        np.testing.assert_array_equal(ref[rid], got[rid])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overcommitted_pool_completes_and_replays_identically(lm, seed):
    """A pool too small for the load, under NaN and OOM faults: every
    request finishes, and a replay gives the same tokens, preemption
    counts and fault counters (the schedule is a function of the plan)."""
    def go():
        reqs = make_trace(8, mean_in=10, mean_out=8, rate=6.0,
                          vocab=lm["cfg"].vocab_size, seed=100 + seed)
        inj = _inj(seed=seed, nan_logits=0.05, oom=0.1)
        out, sched = _serve(lm, reqs, injector=inj, slots=4, n_blocks=14)
        assert all(v is not None for v in out.values())
        return out, sched.metrics(reqs), inj.stats()

    (a, ma, sa), (b, mb, sb) = go(), go()
    assert (ma.preemptions, ma.wasted_tokens, ma.quarantines,
            ma.injected_oom) == (mb.preemptions, mb.wasted_tokens,
                                 mb.quarantines, mb.injected_oom)
    assert sa == sb
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])


# ---------------------------------------------------------------------------
# the scrub, and writes into the storage the captured steps hold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scrub", [False, True], ids=["unscrubbed",
                                                      "scrubbed"])
def test_scrub_needed_on_the_plain_attention(lm, scrub, monkeypatch):
    """The plain attention versions (the CPU's) sum p @ v over every row,
    so a masked NaN row still gives 0 * NaN: without the scrub, the next
    occupant of a contaminated dense slot row goes non-finite; with it,
    its tokens are exact.  (The CUDA kernels never read rows past the
    visible range; ``chip_smoke.py`` holds that on the card.)"""
    vocab = lm["cfg"].vocab_size
    a = Request(0, np.arange(20, dtype=np.int32) % vocab, 8)
    b = Request(1, (np.arange(6, dtype=np.int32) * 7) % vocab, 5)
    ref, _ = _serve(lm, [Request(1, b.prompt, 5)], slots=1, block_size=0)
    sched = build_replica(RS.replace(slots=1, block_size=0), ap=lm["ap"],
                          model=lm["model"], device="cpu")
    if not scrub:
        monkeypatch.setattr(sched, "_scrub_slot",
                            lambda s: sched._tainted.discard(s))
    sched.reset_run_stats()
    sched._admit(0, a, 0.0)
    for t in range(3):
        sched.step(float(t))
    sched._poison_slot(0)
    sched.step(3.0)                     # NaN K and V now past position 6
    assert sched._quarantines == 1 and not sched.active_mask[0]
    sched._requeue.clear()
    sched._admit(0, b, 4.0)
    finite = True
    for t in range(4):
        if not sched.active_mask.any():
            break
        sched.step(5.0 + t)
        finite &= sched._quarantines == 1
    if scrub:
        assert finite and sched.outputs[1] == list(ref[1])
    else:
        assert not finite, "an unscrubbed row did not poison its occupant"


def test_cache_writes_in_place_where_a_captured_step_reads(lm, monkeypatch):
    """The poke, the fork's block copy, the scrub and a handoff's splice
    write the cache's own tensors: a simulated CUDA graph (capture records
    the storage it reads, replay checks it and runs the body) serves the
    whole fault trace, sees every poke (quarantines), and the tokens are
    the fault-free run's.  A rebinding of cache["k"] would fail the
    replay's check."""
    class Graph:
        def replay(self):
            now = {n: t.data_ptr() for n, t in self.cache.items()}
            assert now == self.ptrs, "the cache was rebound"
            self.fn()

    holder = {}

    class Capture:
        def __init__(self, g):
            self.g = g

        def __enter__(self):
            holder["capturing"] = True
            self.g.cache = holder["cache"]
            self.g.ptrs = {n: t.data_ptr()
                           for n, t in holder["cache"].items()}
            self.g.fn = holder["body"]

        def __exit__(self, *exc):
            holder["capturing"] = False
            return False

    vocab = lm["cfg"].vocab_size
    ref, _ = _serve(lm, _trace(vocab))
    sched = build_replica(RS, ap=lm["ap"], model=lm["model"],
                          injector=_inj(seed=7, nan_logits=0.2),
                          device="cpu")
    # graph the serve step, on the CPU, through the simulation: a capture
    # records the body (it does not run it), a replay runs it
    real = sched._serve.body
    holder.update(cache=sched.cache, body=real, capturing=False)
    sched._serve.body = lambda: None if holder["capturing"] else real()
    sched._serve.graph = True
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    done = sched.run(_trace(vocab))
    m = sched.metrics(done)
    assert sched._serve.captures == 1 and sched._serve.replays > 10
    assert m.quarantines > 0
    for r in done:
        np.testing.assert_array_equal(ref[r.rid], r.output)


def test_fork_before_poisoning_a_shared_block(lm):
    """A poke into a block the prefix trie holds forks it first (the copy
    on every rank), so the trie's block keeps its clean K."""
    spec = RS.replace(slots=2, admit_mode="chunked", admit_chunk=16,
                      prefix_cache="on")
    sched = build_replica(spec, ap=lm["ap"], model=lm["model"],
                          device="cpu")
    sched.reset_run_stats()
    prompt = (np.arange(17, dtype=np.int32) * 5) % lm["cfg"].vocab_size
    sched._admit(0, Request(0, prompt, 4), 0.0)
    sched.positions[0] = 16              # the last write in block 1
    shared = sched.alloc.owned(0)[1]
    assert not sched.alloc.is_exclusive(0, 1)
    before = sched.cache["k"][:, shared].clone()
    ptr = sched.cache["k"].data_ptr()
    sched._poison_slot(0)
    new = sched.alloc.owned(0)[1]
    assert new != shared and sched.alloc.is_exclusive(0, 1)
    assert torch.equal(sched.cache["k"][:, shared], before)
    assert torch.isnan(sched.cache["k"][:, new, 7]).all()
    assert sched.cache["k"].data_ptr() == ptr
    sched._evict(0)                      # scrubs the private fork only
    assert torch.equal(sched.cache["k"][:, shared], before)
    assert torch.isfinite(sched.cache["k"]).all()


# ---------------------------------------------------------------------------
# against the JAX batcher under the same plan
# ---------------------------------------------------------------------------


def test_faults_equal_the_jax_batcher():
    """One trace through the JAX batcher and the port's under the same
    FaultPlan (NaN, OOM, straggler), on the same bridged f32 weights: the
    same fault counters and scheduling; greedy tokens equal the reference's
    until a mismatch, which only a step within the gap may show, and nine
    in ten of them at least."""
    jcfg = dataclasses.replace(jax_smoke("llama3.2-1b"), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype=torch.float32)
    jap, tap = JT.make_plan(jcfg, 1), TT.make_plan(tcfg, 1)
    params = jax.jit(JT.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jap)
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    plan = dict(seed=7, nan_logits=0.1, oom=0.3, straggler=0.2)
    kw = dict(n=6, seed=1, mean_out=8)
    jb = JS.ContinuousBatcher(jap, params, slots=3, s_max=64, block_size=8,
                              injector=JF.FaultInjector(JF.FaultPlan(**plan)))
    jdone = jb.run(JS.make_trace(kw["n"], mean_in=10, mean_out=8, rate=3.0,
                                 vocab=tcfg.vocab_size, seed=1))
    reqs = _trace(tcfg.vocab_size, **kw)
    inj = _inj(**plan)
    sched = build_replica(RS, ap=tap, model=model, injector=inj,
                          device="cpu")
    done = sched.run(reqs)
    jm, m = jb.metrics(jdone), sched.metrics(done)
    for f in ("completed", "steps", "preemptions", "quarantines",
              "injected_oom", "straggler_steps", "wasted_tokens"):
        assert getattr(m, f) == getattr(jm, f), f
    assert inj.stats() == jb.injector.stats()
    assert m.quarantines > 0 and m.injected_oom > 0
    checked = 0
    for r, jr in zip(done, jdone):
        want = np.asarray(jr.output)
        seq = np.concatenate([r.prompt, want])
        with torch.inference_mode():
            lg, _ = TT.forward_lm(model, torch.as_tensor(seq[None, :-1]),
                                  tap)
        top2 = torch.topk(lg[0, len(r.prompt) - 1:], 2).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        for t in range(len(want)):
            if r.output[t] != want[t]:
                assert gap[t] <= GAP_TOL, (r.rid, t, gap[t])
                break
            checked += 1
    assert checked >= 0.9 * sum(len(jr.output) for jr in jdone)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def test_serve_cli_fault_flags(capsys):
    done, m = serve.main(["--mode", "trace", "--device", "cpu",
                          "--n-requests", "6", "--block-size", "8",
                          "--fault-plan", "seed=7,nan_logits=0.05,oom=0.1",
                          "--deadline-ms", "500"])
    out = capsys.readouterr().out
    assert "robustness:" in out and "faults injected:" in out
    assert all(r.output is not None or r.shed_reason for r in done)


@pytest.mark.parametrize("flags", [["--fault-plan", "nan_logits=0.1"],
                                   ["--deadline-ms", "5"], ["--disagg"],
                                   ["--replicas", "2"]],
                         ids=["fault_plan", "deadline", "disagg",
                              "replicas"])
def test_serve_cli_refuses_trace_flags_in_batch_mode(flags):
    with pytest.raises(SystemExit, match="trace-mode only"):
        serve.main(["--mode", "batch", "--device", "cpu", *flags])
