"""Disaggregated prefill / decode serving in the port: the KV handoff's
host pieces bitwise against the JAX package's (``KVBundle`` seal and
verify, ``slots_to_heads`` / ``heads_to_slots`` over the two packages'
GQA plans, ``export_slot`` from the port's rank-folded dense and paged
caches at tp 1, 2 and 4 against the reference's on the same contents), and
the bars on the f32 llama smoke model: a disaggregated greedy trace equals
colocated paged serving (full and chunked prefill pools, spec decoding
and a dense cache on the decode pool, pools of different TP on a 2 x 2
mesh), sampled serving equals colocated sampled serving (also under
decode-pool preemption), and the handoff's faults (drops, corruption,
stalls, deadlines) leave every survivor bitwise the fault-free run's;
and the JAX package's coordinator and router, on the same bridged weights
under the same plans, make the port's decisions: the same handoffs,
retries, re-prefills and sheds, the same placements."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.inference import faults as JF  # noqa: E402
from repro.inference import kv_cache as JK  # noqa: E402
from repro.inference import router as JR  # noqa: E402
from repro.inference.scheduler import make_trace as jax_trace  # noqa: E402
from repro.inference import spec as JSP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import plan_gqa as jax_plan_gqa  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.inference import kv_cache as TK  # noqa: E402
from repro_torch.inference import router as TR  # noqa: E402
from repro_torch.inference.disagg import PrefillPool  # noqa: E402
from repro_torch.inference.faults import FaultInjector, FaultPlan  # noqa
from repro_torch.inference.scheduler import (  # noqa: E402
    Request, make_trace, request_sampling_key)
from repro_torch.inference.spec import (ReplicaSpec,  # noqa: E402
                                        build_prefill_pool, build_replica)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import plan_gqa  # noqa: E402

torch.set_num_threads(1)

RS = ReplicaSpec(arch="llama3.2-1b", slots=3, s_max=64)
DS = RS.replace(disagg=True, block_size=8, prefill_block_size=0)
GAP_TOL = 1e-4


@pytest.fixture(scope="module")
def lm():
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype=torch.float32)
    ap = TT.make_plan(cfg, 1)
    return dict(cfg=cfg, ap=ap,
                model=TT.init_params(ap, seed=0, device="cpu"))


def _trace(vocab, n=8, seed=4, mean_out=6, rate=3.0):
    return make_trace(n, mean_in=10, mean_out=mean_out, rate=rate,
                      vocab=vocab, seed=seed)


def _colocated(lm, reqs, **kw):
    sched = build_replica(RS.replace(block_size=8, **kw), ap=lm["ap"],
                          model=lm["model"], device="cpu")
    return {r.rid: r.output for r in sched.run(reqs)}


def _disagg(lm, reqs, spec=DS, injector=None, **kw):
    coord = build_replica(spec.replace(**kw), ap=lm["ap"], model=lm["model"],
                          injector=injector, device="cpu")
    done = coord.run(reqs)
    return {r.rid: r.output for r in done}, coord


def _equal(ref, got):
    for rid in ref:
        np.testing.assert_array_equal(ref[rid], got[rid])


# ---------------------------------------------------------------------------
# the handoff's host pieces against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bundle_seal_and_verify_equal_reference(dtype):
    """Same contents, same checksum as the reference's bundle (bf16 held as
    its bits, named by ``dtype``); a flipped bit or a changed shape fails
    verify; an unsealed bundle verifies."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    ref = JK.KVBundle(k=np.asarray(jnp.asarray(k, dtype)),
                      v=np.asarray(jnp.asarray(-k, dtype))).seal()
    tk, _ = TK.to_host(torch.from_numpy(k).to(getattr(torch, dtype)))
    tv, name = TK.to_host(torch.from_numpy(-k).to(getattr(torch, dtype)))
    ours = TK.KVBundle(k=tk, v=tv, dtype=name).seal()
    assert ours.checksum == ref.checksum and ours.nbytes == ref.nbytes
    ours.verify()
    bad = TK.KVBundle(k=tk.copy(), v=tv, dtype=name,
                      checksum=ours.checksum)
    bad.k.view(np.uint8).reshape(-1)[5] ^= 1
    with pytest.raises(TK.BundleIntegrityError):
        bad.verify()
    TK.KVBundle(k=tk, v=tv).verify()
    back = TK.to_device(ours.k, ours.dtype, "cpu")
    assert back.dtype == getattr(torch, dtype)
    assert torch.equal(back, torch.from_numpy(k).to(back.dtype))


@pytest.mark.parametrize("n_q,n_kv", [(4, 2), (8, 2), (6, 3)])
def test_slots_and_heads_equal_reference(n_q, n_kv):
    """The port's plan_gqa is the reference's, and the slot / head maps
    give the reference's arrays at tp 1, 2 and 4 (replicated and dead
    slots included), round-tripping to the identity."""
    rng = np.random.default_rng(1)
    canon = rng.standard_normal((2, 5, n_kv, 8)).astype(np.float32)
    for tp in (1, 2, 4):
        ours, ref = plan_gqa(n_q, n_kv, tp), jax_plan_gqa(n_q, n_kv, tp)
        assert tuple(ours.kv_map) == tuple(ref.kv_map)
        slots = TK.heads_to_slots(canon, ours.kv_map)
        np.testing.assert_array_equal(
            slots, JK.heads_to_slots(canon, ref.kv_map))
        np.testing.assert_array_equal(
            TK.slots_to_heads(slots, ours.kv_map),
            JK.slots_to_heads(slots, ref.kv_map))
        np.testing.assert_array_equal(
            TK.slots_to_heads(slots, ours.kv_map), canon)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_export_slot_equals_reference(tp, paged):
    """A random global cache in the reference's layout (dense (L, B, S,
    tp*u, hd); paged (L, n_blocks, bs, tp*u, hd), one pool cut over the
    heads), laid out as the port folds it (rank r's u slots in its rows or
    its pool), exports the reference's bundle bitwise; the splice's states
    (``bundle_states``) are that rank layout again."""
    rng = np.random.default_rng(tp)
    plan = plan_gqa(4, 2, tp)
    L, B, S, bs, hd, T, slot = 2, 3, 32, 8, 16, 13, 1
    u = plan.u
    if paged:
        nb = B * (S // bs) + 1
        g = rng.standard_normal((L, nb, bs, tp * u, hd)).astype(np.float32)
        row = rng.permutation(np.arange(1, nb))[:S // bs]
        ref = JK.export_slot({"k": g, "v": -g, "block_tbl": None}, slot, T,
                             plan.kv_map, table_row=row)
        folded = torch.from_numpy(g.reshape(L, nb, bs, tp, u, hd)).permute(
            0, 3, 1, 2, 4, 5).reshape(L, tp * nb, bs, u, hd)
        cache = {"k": folded, "v": -folded,
                 "block_tbl": torch.zeros((tp * B, S // bs), dtype=torch.int32)}
        ours = TK.export_slot(cache, slot, T, plan.kv_map, table_row=row)
    else:
        g = rng.standard_normal((L, B, S, tp * u, hd)).astype(np.float32)
        ref = JK.export_slot({"k": g, "v": -g}, slot, T, plan.kv_map)
        folded = torch.from_numpy(g.reshape(L, B, S, tp, u, hd)).permute(
            0, 3, 1, 2, 4, 5).reshape(L, tp * B, S, u, hd)
        ours = TK.export_slot({"k": folded, "v": -folded}, slot, T,
                              plan.kv_map)
    np.testing.assert_array_equal(ours.k, ref.k)
    np.testing.assert_array_equal(ours.v, ref.v)
    assert ours.seal().checksum == ref.seal().checksum
    k, _ = TK.bundle_states(ours, plan.kv_map, u, "cpu")
    want = torch.from_numpy(JK.heads_to_slots(ref.k, plan.kv_map)).view(
        L, T, tp, u, hd).permute(0, 2, 1, 3, 4)
    assert k.shape == (L, tp, T, u, hd) and torch.equal(k, want)


def test_export_refuses_the_trash_block_and_isolates_neighbours(lm):
    """Dense and paged exports after the same admission are equal; a freed
    neighbour leaves the export unchanged; a freed slot's all-trash row
    is refused."""
    vocab = lm["cfg"].vocab_size
    p0 = (np.arange(12, dtype=np.int32) * 3) % vocab
    p1 = (np.arange(20, dtype=np.int32) * 5) % vocab
    kv_map = lm["ap"].gqa.kv_map

    def admit_two(**kw):
        sched = build_replica(RS.replace(**kw), ap=lm["ap"],
                              model=lm["model"], device="cpu")
        assert sched._admit(0, Request(0, p0, 4), 0.0)
        assert sched._admit(1, Request(1, p1, 4), 0.0)
        return sched

    dense, paged = admit_two(), admit_two(block_size=8)
    a = TK.export_slot(dense.cache, 0, len(p0), kv_map)
    b = TK.export_slot(paged.cache, 0, len(p0), kv_map,
                       table_row=paged.alloc.table[0])
    np.testing.assert_array_equal(a.k, b.k)
    paged.alloc.free(1)
    c = TK.export_slot(paged.cache, 0, len(p0), kv_map,
                       table_row=paged.alloc.table[0])
    np.testing.assert_array_equal(b.v, c.v)
    with pytest.raises(AssertionError):
        TK.export_slot(paged.cache, 1, len(p1), kv_map,
                       table_row=paged.alloc.table[1])


# ---------------------------------------------------------------------------
# the bars
# ---------------------------------------------------------------------------


def test_prefill_pool_full_and_chunked_bundles(lm):
    """The prefill-only step (full) and the chunked pool's export (dense
    or paged) give the same first token and the same K/V to f32
    rounding; the chunked ones are bitwise each other's."""
    prompt = (np.arange(23, dtype=np.int32) * 7) % lm["cfg"].vocab_size
    req = Request(0, prompt, 8)
    tok, full = build_prefill_pool(RS, ap=lm["ap"], model=lm["model"],
                                   device="cpu").prefill(req)
    got = []
    for kw in (dict(), dict(block_size=8)):
        pool = build_prefill_pool(
            RS.replace(admit_mode="chunked", admit_chunk=16, **kw),
            ap=lm["ap"], model=lm["model"], device="cpu")
        t, b = pool.prefill(req)
        assert t == tok and b.checksum is not None
        np.testing.assert_allclose(b.k, full.k, atol=1e-5)
        got.append(b)
    np.testing.assert_array_equal(got[0].k, got[1].k)
    assert full.n_tokens == 23
    assert tuple(full.rng) == request_sampling_key(0, 0)


@pytest.mark.parametrize("case", ["full", "chunked", "spec", "dense"])
def test_disagg_equals_colocated_paged(lm, case):
    """A disaggregated greedy trace == colocated paged serving, request for
    request: a full (dense) prefill pool, a chunked paged pool, spec ngram
    decoding on the decode pool, a dense decode pool."""
    vocab = lm["cfg"].vocab_size
    spec = {"full": DS,
            "chunked": DS.replace(admit_mode="chunked", admit_chunk=16,
                                  prefill_block_size=None),
            "spec": DS.replace(spec_mode="ngram", spec_k=4),
            "dense": DS.replace(block_size=0)}[case]
    ref = _colocated(lm, _trace(vocab))
    reqs = _trace(vocab)
    got, coord = _disagg(lm, reqs, spec)
    _equal(ref, got)
    m = coord.metrics(reqs)
    assert m.completed == m.handoffs == len(reqs) and m.transfer_bytes > 0
    if case == "spec":
        assert m.decode_pool["spec_steps"] > 0


def test_disagg_pools_of_different_tp(lm):
    """A prefill pool at tp=1 (own mesh-less layout) and one at tp=2 in
    front of a tp=4 decode pool on a 2 x 2 mesh (hier_rd): each equals
    colocated serving at tp=4 wherever the gap is clear (f32 sums in
    another order), and the two disaggregated runs are equal."""
    cfg, vocab = lm["cfg"], lm["cfg"].vocab_size
    ap4 = TT.make_plan(cfg, 4)
    mesh, _ = mesh_and_ctx(4, 2, device="cpu")
    model4 = TT.init_params(ap4, seed=0, device="cpu", mesh=mesh)
    col = build_replica(RS.replace(tp=4, pods=2, ar_strategy="hier_rd",
                                   block_size=8), ap=ap4, model=model4,
                        device="cpu")
    ref = {r.rid: r.output for r in col.run(_trace(vocab))}
    outs = []
    for ptp in (1, 2):
        app = TT.make_plan(cfg, ptp)
        pmesh = mesh_and_ctx(ptp, 1, device="cpu")[0]
        coord = build_replica(
            DS.replace(prefill_tp=ptp, decode_tp=4, decode_pods=2,
                       ar_strategy="hier_rd"),
            prefill_ap=app, prefill_model=TT.init_params(
                app, seed=0, device="cpu", mesh=pmesh),
            decode_ap=ap4, decode_model=model4, device="cpu")
        assert coord.prefill.mesh is not coord.decode.mesh
        reqs = _trace(vocab)
        done = coord.run(reqs)
        outs.append({r.rid: r.output for r in done})
        checked = 0
        for r in reqs:
            seq = np.concatenate([r.prompt, ref[r.rid]])
            with torch.inference_mode():
                lg, _ = TT.forward_lm(lm["model"],
                                      torch.as_tensor(seq[None, :-1]),
                                      lm["ap"])
            top2 = torch.topk(lg[0, len(r.prompt) - 1:], 2).values
            gap = (top2[:, 0] - top2[:, 1]).numpy()
            for t in range(len(ref[r.rid])):
                if gap[t] <= GAP_TOL:
                    break
                assert r.output[t] == ref[r.rid][t], (ptp, r.rid, t)
                checked += 1
        assert checked >= 0.9 * sum(len(v) for v in ref.values())
    _equal(outs[0], outs[1])


def test_disagg_sampled_equals_colocated_also_under_preemption(lm):
    """Sampled (temperature 1.5, top-20): the chain's key rides the
    bundle, so disaggregated streams equal colocated sampled serving of
    the same trace, with a roomy decode pool and with one of 13 blocks
    that preempts (the recompute re-prefills on the request's chain); and
    the streams are not the greedy ones."""
    vocab = lm["cfg"].vocab_size
    samp = dict(temperature=1.5, top_k=20, seed=0)
    rng = np.random.default_rng(5)
    protos = [rng.integers(0, vocab, 16).astype(np.int32) for _ in range(3)]

    def reqs():
        return [Request(i, p, 40, 0.0) for i, p in enumerate(protos)]

    ref = _colocated(lm, reqs(), **samp)
    got, _ = _disagg(lm, reqs(), **samp)
    _equal(ref, got)
    got, coord = _disagg(lm, reqs(), n_blocks=13, **samp)
    assert coord.metrics([]).preemptions > 0
    assert coord.handoffs > 3
    _equal(ref, got)
    greedy = _colocated(lm, reqs())
    assert any(not np.array_equal(greedy[i], ref[i]) for i in ref)


def test_admit_prefilled_waits_for_room_and_refuses_corruption(lm):
    """``admit_prefilled`` changes nothing when the pool cannot hold the
    bundle, admits it once room frees, and raises on a corrupt bundle
    before any change; the splice writes the cache's own tensors."""
    prompt = (np.arange(24, dtype=np.int32) * 3) % lm["cfg"].vocab_size
    pool = build_prefill_pool(RS, ap=lm["ap"], model=lm["model"],
                              device="cpu")
    tok, bundle = pool.prefill(Request(0, prompt, 4))
    # 11 blocks of 8 = 10 usable; slot 1 takes 8, leaving 2 < the 4 needed
    decode = build_replica(RS.replace(slots=2, block_size=8, n_blocks=11),
                           ap=lm["ap"], model=lm["model"], device="cpu")
    ptr = decode.cache["k"].data_ptr()
    assert decode.alloc.ensure(1, 64)
    req = Request(0, prompt, 4)
    assert not decode.admit_prefilled(0, req, bundle, tok, 0.0)
    assert decode.active[0] is None and not decode.active_mask[0]
    decode.alloc.free(1)
    bad = dataclasses.replace(bundle, k=bundle.k.copy())
    FaultInjector.corrupt_bundle(bad)
    with pytest.raises(TK.BundleIntegrityError):
        decode.admit_prefilled(0, req, bad, tok, 0.0)
    assert decode.active[0] is None
    assert decode.admit_prefilled(0, req, bundle, tok, 0.0)
    assert decode.positions[0] == len(prompt) and decode.outputs[0] == [tok]
    assert decode.cache["k"].data_ptr() == ptr
    back = TK.export_slot(decode.cache, 0, len(prompt), lm["ap"].gqa.kv_map,
                          table_row=decode.alloc.table[0])
    np.testing.assert_array_equal(back.k, bundle.k)


HANDOFF_FAULTS = {
    "drop": (dict(seed=11, handoff_drop=0.3), {}),
    "corrupt": (dict(seed=5, handoff_corrupt=0.5), {}),
    "decode_stall": (dict(seed=2, decode_stall=0.4, stall_steps=2),
                     dict(max_ready=3, prefill_per_step=4)),
    "prefill_stall": (dict(seed=6, prefill_stall=0.5, stall_steps=3), {}),
    "deadline": (dict(seed=3, prefill_stall=0.6, stall_steps=4),
                 dict(deadline_ms=4.0)),
    "decode_nan_oom": (dict(seed=7, nan_logits=0.15, oom=0.3), {}),
}


@pytest.mark.parametrize("kind", list(HANDOFF_FAULTS))
def test_handoff_faults_keep_survivors_bitwise(lm, kind):
    """Each fault of the disaggregated path: every survivor bitwise the
    fault-free colocated run, every other request shed with its reason
    (re-prefills past their cap, deadlines), the kind's counter moving."""
    plan, kw = HANDOFF_FAULTS[kind]
    vocab = lm["cfg"].vocab_size
    ref = _colocated(lm, _trace(vocab))
    reqs = _trace(vocab)
    got, coord = _disagg(lm, reqs, injector=FaultInjector(FaultPlan(**plan)),
                         **kw)
    m = coord.metrics(reqs)
    assert m.completed + m.shed_requests == len(reqs)
    for r in reqs:
        if r.output is None:
            assert r.shed_reason in ("handoff_corrupt", "handoff_failed",
                                     "deadline") and r.shed_step >= 0
        else:
            np.testing.assert_array_equal(ref[r.rid], r.output)
    moved = {"drop": m.handoff_drops and m.handoff_retries,
             "corrupt": m.handoff_corrupt and m.handoff_reprefills,
             "decode_stall": m.decode_stall_steps and m.backpressure_steps
             and m.peak_ready_depth <= 3,
             "prefill_stall": m.prefill_stall_steps,
             "deadline": m.shed_requests,
             "decode_nan_oom": m.decode_pool["quarantines"]
             and m.decode_pool["injected_oom"]}[kind]
    assert moved, m


def test_total_handoff_failure_sheds_everything_and_ends(lm):
    reqs = _trace(lm["cfg"].vocab_size, n=5)
    got, coord = _disagg(lm, reqs,
                         injector=FaultInjector(FaultPlan(seed=1,
                                                          handoff_drop=1.0)),
                         max_handoff_retries=2, max_reprefills=1)
    assert all(v is None for v in got.values())
    assert all(r.shed_reason == "handoff_failed" for r in reqs)
    assert coord.handoff_drops <= len(reqs) * 2 * 3


# ---------------------------------------------------------------------------
# against the JAX coordinator and router under the same plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bridged():
    """The JAX smoke llama in f32 and the port's model on its weights."""
    jcfg = dataclasses.replace(jax_smoke("llama3.2-1b"), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype=torch.float32)
    jap, tap = JT.make_plan(jcfg, 1), TT.make_plan(tcfg, 1)
    params = jax.jit(JT.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jap)
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return dict(jap=jap, params=params, tap=tap, model=model,
                vocab=tcfg.vocab_size)


def _gap_checked(b, reqs, want):
    """Teacher-forced on the reference's stream: every token of ``reqs``
    must equal ``want`` until the first mismatch, which is allowed only
    at a step whose top-1/top-2 gap is within GAP_TOL (f32 sums in another
    order); returns the tokens checked."""
    checked = 0
    for r in reqs:
        ref = np.asarray(want[r.rid])
        seq = np.concatenate([r.prompt, ref])
        with torch.inference_mode():
            lg, _ = TT.forward_lm(b["model"], torch.as_tensor(seq[None, :-1]),
                                  b["tap"])
        top2 = torch.topk(lg[0, len(r.prompt) - 1:], 2).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        for t in range(len(ref)):
            if r.output[t] != ref[t]:
                assert gap[t] <= GAP_TOL, (r.rid, t, gap[t])
                break
            checked += 1
    return checked


def _shed(reqs):
    return sorted((r.rid, r.shed_reason, r.shed_step) for r in reqs
                  if r.output is None)


DISAGG_COUNTERS = (
    "completed", "steps", "preemptions", "handoffs", "transfer_bytes",
    "peak_ready_depth", "peak_pending_depth", "handoff_drops",
    "handoff_retries", "handoff_corrupt", "handoff_reprefills",
    "shed_requests", "backpressure_steps", "prefill_stall_steps",
    "decode_stall_steps", "ready_cap", "ttft_steps_p50", "ttft_steps_p99",
    "prefill_steps_p50", "transfer_steps_p50", "tpot_steps_p50")


@pytest.mark.parametrize("case", [*HANDOFF_FAULTS, "round_robin",
                                  "least_queue", "ttft_aware"])
def test_decisions_equal_the_jax_package(bridged, case):
    """One trace through the JAX package and the port on the same f32
    weights. A handoff fault case: ``build_replica(disagg)`` on both
    sides under the same plan gives the same handoff, retry, corruption,
    re-prefill, backpressure and stall counts, the same TTFT split, the
    same shed requests with their reasons and steps, and the same fault
    events. A policy case: a router over two colocated batchers (a NaN
    plan, folded per replica) places every request where the reference
    does. Greedy tokens equal the reference's wherever the gap is clear,
    nine in ten of them at least."""
    b = bridged
    if case in HANDOFF_FAULTS:
        plan, kw = HANDOFF_FAULTS[case]
        jspec = JSP.ReplicaSpec(arch="llama3.2-1b", slots=3, s_max=64,
                                disagg=True, block_size=8,
                                prefill_block_size=0, **kw)
        jrep = JSP.build_replica(jspec, ap=b["jap"], params=b["params"],
                                 injector=JF.FaultInjector(
                                     JF.FaultPlan(**plan)))
        rep = build_replica(DS.replace(**kw), ap=b["tap"], model=b["model"],
                            injector=FaultInjector(FaultPlan(**plan)),
                            device="cpu")
    else:
        jspec = JSP.ReplicaSpec(arch="llama3.2-1b", slots=2, s_max=64,
                                block_size=8,
                                fault_plan="seed=5,nan_logits=0.2")
        spec = RS.replace(slots=2, block_size=8,
                          fault_plan="seed=5,nan_logits=0.2")
        jrep = JR.Router([JSP.build_replica(jspec, ap=b["jap"],
                                            params=b["params"], replica_id=i)
                          for i in range(2)], policy=case,
                         cost_fn=JR.prefill_cost_model(jspec))
        rep = TR.Router([build_replica(spec, ap=b["tap"], model=b["model"],
                                       replica_id=i, device="cpu")
                         for i in range(2)], policy=case,
                        cost_fn=TR.prefill_cost_model(spec))
    # the handoff cases' trace is the one the bars above use
    n, targs = (8, dict(rate=3.0, seed=4)) if case in HANDOFF_FAULTS \
        else (10, dict(rate=8.0, seed=3))
    targs.update(mean_in=10, mean_out=6, vocab=b["vocab"])
    jreqs, reqs = jax_trace(n, **targs), make_trace(n, **targs)
    jrep.run(jreqs)
    rep.run(reqs)
    jm, m = jrep.metrics(jreqs), rep.metrics(reqs)
    assert _shed(reqs) == _shed(jreqs)
    if case in HANDOFF_FAULTS:
        np.testing.assert_equal({f: getattr(m, f) for f in DISAGG_COUNTERS},
                                {f: getattr(jm, f) for f in DISAGG_COUNTERS})
        for f in ("quarantines", "injected_oom", "wasted_tokens"):
            assert m.decode_pool[f] == jm.decode_pool[f], f
        assert rep.injector.stats() == jrep.injector.stats()
    else:
        assert rep.placements == jrep.placements
        assert [[r.rid for r in a] for a in rep.assigned] == \
            [[r.rid for r in a] for a in jrep.assigned]
        for p, jp in zip(m.per_replica, jm.per_replica):
            for f in ("completed", "steps", "preemptions", "quarantines"):
                assert getattr(p, f) == getattr(jp, f), f
        assert [r.injector.stats() for r in rep.replicas] == \
            [r.injector.stats() for r in jrep.replicas]
    done = [r for r in reqs if r.output is not None]
    want = {r.rid: r.output for r in jreqs if r.output is not None}
    assert len(want) == len(done) == len(reqs) - len(_shed(reqs))
    assert _gap_checked(b, done, want) >= \
        0.9 * sum(len(v) for v in want.values())


def test_disagg_metrics_attribution_and_buckets(lm):
    reqs = _trace(lm["cfg"].vocab_size)
    _, coord = _disagg(lm, reqs)
    m = coord.metrics(reqs)
    assert m.ttft_steps_p50 == pytest.approx(
        m.prefill_steps_p50 + m.transfer_steps_p50, abs=2.0)
    assert m.prefill_ar_bucket > m.decode_ar_bucket
    d = m.to_dict()
    assert d["prefill_pool"]["prefills"] == len(reqs)
    assert d["decode_pool"]["completed"] == len(reqs)
    assert "graph_captures" in d["prefill_pool"]
    assert "ttft_steps_samples" not in d


def test_disagg_refuses_non_dense():
    cfg = dataclasses.replace(get_smoke("rwkv6-7b"), dtype=torch.float32)
    with pytest.raises(ValueError, match="dense"):
        PrefillPool(TT.make_plan(cfg, 1), None, s_max=64, device="cpu")


def test_serve_cli_disagg(capsys):
    done, m = serve.main(["--mode", "trace", "--device", "cpu",
                          "--n-requests", "5", "--block-size", "8",
                          "--disagg", "--prefill-tp", "2",
                          "--decode-tp", "4", "--decode-pods", "2",
                          "--ar-strategy", "hier_rd",
                          "--fault-plan", "seed=5,handoff_corrupt=0.3"])
    assert m.completed + m.shed_requests == 5
    out = capsys.readouterr().out
    assert "prefill tp=2x1" in out and "decode tp=4x2" in out
    assert "handoff:" in out and "robustness:" in out
