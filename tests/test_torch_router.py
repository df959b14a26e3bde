"""The port's replica spec and router: the placement policies and the
analytic prefill cost against the JAX package's, every refusal of the
reference's ``BAD_COMBOS`` with the same message fragment from both
packages, the JSON round trip and its unknown keys, the refusals the port
adds (what waits for ROADMAP item 11), the one-card replica
carving, and the bars on the f32 llama smoke model: a ``round_robin``
fleet is N single replicas request for request (also under a fault plan,
each replica its own schedule), every policy completes a bursty trace,
and the metrics merge losslessly."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import comm_model as JCM  # noqa: E402
from repro.inference import router as JR  # noqa: E402
from repro.inference import spec as JSP  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.inference import router as TR  # noqa: E402
from repro_torch.inference.disagg import DisaggMetrics  # noqa: E402
from repro_torch.inference.scheduler import (  # noqa: E402
    Request, ServeMetrics, make_trace)
from repro_torch.inference.spec import (ReplicaSpec, ServeSpec,  # noqa
                                        SpecError, build_replica,
                                        make_injector)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.parallel.topology import (  # noqa: E402
    mesh_and_ctx, replica_device_groups)

torch.set_num_threads(1)

RS = ReplicaSpec(arch="llama3.2-1b", slots=2, s_max=64)
JRS = JSP.ReplicaSpec(arch="llama3.2-1b", slots=2, s_max=64)


@pytest.fixture(scope="module")
def lm():
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype=torch.float32)
    ap = TT.make_plan(cfg, 1)
    return dict(cfg=cfg, ap=ap,
                model=TT.init_params(ap, seed=0, device="cpu"))


def _copy(reqs):
    return [Request(r.rid, r.prompt.copy(), r.max_new, r.arrival_s)
            for r in reqs]


# ---------------------------------------------------------------------------
# placement and cost against the JAX package's
# ---------------------------------------------------------------------------


def _loads(mod, rng, n):
    return [mod.ReplicaLoad(
        queue_depth=int(rng.integers(0, 4)),
        queued_prompt_tokens=int(rng.integers(0, 200)),
        active=int(rng.integers(0, 3)), slots=2,
        active_remaining=int(rng.integers(0, 50)),
        est_queue_cost=float(rng.integers(0, 4)),
        est_active_cost=float(rng.integers(0, 4))) for _ in range(n)]


@pytest.mark.parametrize("policy", list(TR.POLICIES))
def test_policies_equal_reference(policy):
    """Each policy picks the reference's replica over 300 seeded load
    snapshots (ties included: costs are small integers)."""
    rng = np.random.default_rng(0)
    for i in range(300):
        state = rng.bit_generator.state
        ours = _loads(TR, rng, 3)
        rng.bit_generator.state = state
        ref = _loads(JR, rng, 3)
        assert TR.POLICIES[policy](ours, i) == JR.POLICIES[policy](ref, i)


@pytest.mark.parametrize("kw", [dict(), dict(tp=8, pods=2),
                                dict(tp=4, pods=1),
                                dict(disagg=True, prefill_tp=8,
                                     prefill_pods=2),
                                dict(arch="qwen3-moe-30b-a3b", smoke=False,
                                     tp=8, pods=4)],
                         ids=["tp1", "tp8", "tp4", "disagg", "moe_full"])
def test_prefill_cost_model_equals_reference(kw):
    """The port's default network (Perlmutter, its chip the A100 row) gives
    the reference's estimate on that network, prompt by prompt."""
    ours = TR.prefill_cost_model(RS.replace(**kw))
    ref = JR.prefill_cost_model(JRS.replace(**kw),
                                net=JCM.NETWORKS["perlmutter"])
    for s in (1, 8, 64, 128, 512, 2048):
        assert ours(s) == pytest.approx(ref(s), rel=1e-12)
    assert ours(8) <= ours(512) < ours(2048)


def test_router_constructor_refuses():
    with pytest.raises(ValueError, match="at least one"):
        TR.Router([])
    with pytest.raises(ValueError, match="unknown router policy"):
        TR.Router([object()], policy="fastest")

    class _Coord:
        decode = None
    with pytest.raises(ValueError, match="heterogeneous"):
        TR.Router([object(), _Coord()])


# ---------------------------------------------------------------------------
# the spec: refusals, JSON, factories
# ---------------------------------------------------------------------------


# the reference's tests/test_router.py BAD_COMBOS: (fields, mode, fragment)
BAD_COMBOS = [
    (dict(arch="llama-999t"), "trace", "arch"),
    (dict(ar_strategy="warp"), "trace", "ar_strategy"),
    (dict(seq_parallel="maybe"), "trace", "seq_parallel"),
    (dict(ar_quant="int2"), "trace", "ar_quant"),
    (dict(admit_mode="eager"), "trace", "admit_mode"),
    (dict(spec_mode="psychic"), "trace", "spec_mode"),
    (dict(slots=0), "trace", "slots"),
    (dict(tp=0), "trace", "tp"),
    (dict(tp=6, pods=4), "trace", "divisible"),
    (dict(admit_mode="chunked", admit_chunk=28), "trace", "admit_chunk"),
    (dict(spec_mode="ngram", spec_k=0), "trace", "spec_k"),
    (dict(ar_quant="auto"), "trace", "ar_strategy"),
    (dict(kv_quant=True, admit_mode="chunked"), "trace", "chunked"),
    (dict(kv_quant=True, block_size=8), "trace", "block_size"),
    (dict(kv_quant=True, spec_mode="ngram"), "trace", "spec_mode"),
    (dict(kv_quant=True, disagg=True), "trace", "disagg"),
    (dict(spec_adaptive=True), "batch", "trace-mode only"),
    (dict(fault_plan="oom=0.1"), "batch", "trace-mode only"),
    (dict(deadline_ms=5.0), "batch", "trace-mode only"),
    (dict(disagg=True), "batch", "trace-mode only"),
    (dict(kv_quant=True), "batch", "trace-mode only"),
    (dict(block_size=8, tp=8), "batch", "local-path"),
    (dict(prefix_cache="maybe"), "trace", "prefix_cache"),
    (dict(prefix_cache="on"), "trace", "paged"),
    (dict(prefix_cache="on", block_size=8, kv_quant=True), "trace",
     "prefix_cache is incompatible with kv_quant"),
    (dict(prefix_cache="on", block_size=8, disagg=True), "trace",
     "prefix_cache is incompatible with disagg"),
    (dict(prefix_cache="on", block_size=8, admit_chunk=12), "trace",
     "prefix_cache"),
    (dict(prefix_cache="on", block_size=8, admit_chunk=0), "trace",
     "prefix_cache"),
    (dict(prefix_cache="on", block_size=8, prefix_capacity=0), "trace",
     "prefix_capacity"),
    (dict(prefix_cache="on", block_size=8, arch="hymba-1.5b"), "trace",
     "dense"),
    (dict(prefix_cache="on", block_size=8), "batch", "trace-mode only"),
    (dict(disagg=True, prefill_tp=0), "trace", "prefill_tp"),
    (dict(disagg=True, prefill_tp=6, prefill_pods=4), "trace", "divisible"),
    (dict(disagg=True, decode_tp=6, decode_pods=4), "trace", "divisible"),
    (dict(disagg=True, max_reprefills=-1), "trace", "max_reprefills"),
]


@pytest.mark.parametrize("kw,mode,frag", BAD_COMBOS,
                         ids=[f"{sorted(kw)[0]}-{m}" for kw, m, _ in
                              BAD_COMBOS])
def test_validate_refuses_as_the_reference(kw, mode, frag):
    """Each combination is refused by both packages, by the replica's and
    the deployment's validate, with the same message."""
    with pytest.raises(JSP.SpecError) as ref:
        JRS.replace(**kw).validate(mode=mode)
    with pytest.raises(SpecError, match=frag) as ours:
        RS.replace(**kw).validate(mode=mode)
    assert str(ours.value) == str(ref.value)
    with pytest.raises(SpecError, match=frag):
        ServeSpec(replica=RS.replace(**kw), mode=mode).validate()


def test_deployment_validate_refuses():
    with pytest.raises(SpecError, match="replicas"):
        ServeSpec(replica=RS, replicas=0).validate()
    with pytest.raises(SpecError, match="router_policy"):
        ServeSpec(replica=RS, router_policy="fastest").validate()
    with pytest.raises(SpecError, match="trace-mode only"):
        ServeSpec(replica=RS, replicas=2, mode="batch").validate()


ROUND_TRIP = [
    ServeSpec(replica=RS),
    ServeSpec(replica=RS.replace(block_size=8, n_blocks=13,
                                 admit_mode="chunked", admit_chunk=16)),
    ServeSpec(replica=RS.replace(tp=8, pods=2, ar_strategy="auto",
                                 overlap=True, seq_parallel="auto",
                                 ar_quant="auto", overlap_chunks=2)),
    ServeSpec(replica=RS.replace(fault_plan="nan_logits=0.1,seed=3",
                                 deadline_ms=12.0, layers=1, smoke=False)),
    ServeSpec(replica=RS.replace(disagg=True, prefill_tp=2, decode_tp=2,
                                 prefill_block_size=0, block_size=8,
                                 max_ready=3, prefill_per_step=4)),
    ServeSpec(replica=RS, replicas=4, router_policy="ttft_aware"),
]


@pytest.mark.parametrize("spec", ROUND_TRIP, ids=range(len(ROUND_TRIP)))
def test_spec_json_round_trip(spec):
    assert ServeSpec.from_json(spec.to_json()) == spec


def test_spec_json_refuses_unknown_keys_and_reads_the_reference():
    """Typo'd keys are refused as the reference refuses them; a spec the
    reference wrote (no port-only field) reads back with the port's
    defaults for ``layers`` and ``overlap_chunks``."""
    d = json.loads(ServeSpec(replica=RS).to_json())
    d["replica"]["blok_size"] = 8
    with pytest.raises(SpecError, match="blok_size"):
        ServeSpec.from_json(json.dumps(d))
    d = json.loads(ServeSpec(replica=RS).to_json())
    d["router_polcy"] = "round_robin"
    with pytest.raises(SpecError, match="router_polcy"):
        ServeSpec.from_json(json.dumps(d))
    with pytest.raises(SpecError, match="replica"):
        ServeSpec.from_json("{}")
    ref = JSP.ServeSpec(replica=JRS.replace(tp=4, pods=2, disagg=True),
                        replicas=2)
    ours = ServeSpec.from_json(ref.to_json())
    assert ours == ServeSpec(replica=RS.replace(tp=4, pods=2, disagg=True),
                             replicas=2)


def test_build_refuses_what_waits_for_later_items(lm):
    """What the reference accepts and builds but the port has not ported:
    ``fsdp_serve`` (ROADMAP item 11); ``seq_parallel`` builds now, its
    ctx carrying the knob.  The spec's own checks run first.  ``kv_quant`` now builds (a batcher over
    the int8 cache) and keeps the reference's own build-time refusals,
    each with its message: paged, chunked, spec, prefix, disagg, batch
    mode."""
    kw = dict(ap=lm["ap"], model=lm["model"], device="cpu")
    with pytest.raises(SpecError, match="admit_chunk"):
        build_replica(RS.replace(admit_mode="chunked", admit_chunk=28), **kw)
    for bad, item in ((dict(fsdp_serve=True), "item 11"),):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            build_replica(RS.replace(**bad), **kw)
    assert build_replica(RS.replace(seq_parallel="on"), **kw) \
        .ctx.seq_parallel == "on"
    built = build_replica(RS.replace(kv_quant=True), **kw)
    assert built.cache["k"].dtype == torch.int8 and "k_scale" in built.cache
    for bad, msg in (
            (dict(block_size=8), "kv_quant is incompatible with block_size"),
            (dict(admit_mode="chunked"),
             "kv_quant is incompatible with admit_mode='chunked'"),
            (dict(spec_mode="ngram"), "kv_quant is incompatible with spec"),
            (dict(prefix_cache="on", block_size=8),
             "prefix_cache is incompatible with kv_quant"),
            (dict(disagg=True), "kv_quant is incompatible with disagg")):
        with pytest.raises(SpecError, match=msg):
            build_replica(RS.replace(kv_quant=True, **bad), **kw)
        with pytest.raises(JSP.SpecError, match=msg):
            JSP.ReplicaSpec(arch=RS.arch, kv_quant=True, **bad).validate()
    with pytest.raises(SpecError, match="kv_quant is trace-mode only"):
        ServeSpec(replica=RS.replace(kv_quant=True), mode="batch").validate()


def test_make_injector_decorrelates_replicas():
    spec = RS.replace(fault_plan="nan_logits=0.2,seed=3")
    for i in (0, 1, 2):
        ours = make_injector(spec, i)
        ref = JSP.make_injector(JRS.replace(fault_plan=spec.fault_plan), i)
        assert ours.plan.to_dict() == ref.plan.to_dict()
    assert make_injector(spec, 1).plan.seed == 3 + 7919
    assert make_injector(RS, 1) is None


def test_one_card_replica_carving():
    """Every replica gets the one device and builds its own virtual mesh
    (own exchange workspace) there; no device count is refused."""
    assert replica_device_groups(3, 8, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        replica_device_groups(0, 1, "cpu")
    a, ctx, tp = mesh_and_ctx(4, 2, ar_strategy="hier_rd", overlap=True,
                              ar_quant="int8", device="cpu")
    b, _, _ = mesh_and_ctx(4, 2, device="cpu")
    assert tp == 4 and a is not b and a.workspace is not b.workspace
    assert ctx.overlap_matmul and ctx.ar_quant == "int8"
    assert mesh_and_ctx(1, 1, device="cpu")[0] is None


# ---------------------------------------------------------------------------
# the bars: fleet == N singles, policies, metrics merge
# ---------------------------------------------------------------------------


def _fleet_parity(lm, fault_plan=None):
    spec = RS if fault_plan is None else RS.replace(fault_plan=fault_plan)
    vocab = lm["cfg"].vocab_size
    reqs = make_trace(8, mean_in=10, mean_out=6, rate=4.0, vocab=vocab,
                      seed=2)
    kw = dict(ap=lm["ap"], model=lm["model"], device="cpu")
    fleet = TR.Router([build_replica(spec, replica_id=i, **kw)
                       for i in range(2)], policy="round_robin")
    done = fleet.run(_copy(reqs))
    by_arrival = sorted(reqs, key=lambda r: r.arrival_s)
    for i in range(2):
        solo = build_replica(spec, replica_id=i, **kw)
        sub = _copy([r for k, r in enumerate(by_arrival) if k % 2 == i])
        solo_done = {r.rid: r for r in solo.run(sub)}
        routed = [r for r in done if r.rid in solo_done]
        assert len(routed) == len(sub)
        for r in routed:
            s = solo_done[r.rid]
            if s.output is None:
                assert r.output is None and r.shed_reason == s.shed_reason
            else:
                np.testing.assert_array_equal(r.output, s.output)
    return fleet, done


def test_fleet_round_robin_equals_singles(lm):
    fleet, done = _fleet_parity(lm)
    assert fleet.placements == [4, 4]
    m = fleet.metrics(done)
    assert m.fleet.completed == 8 and m.load_imbalance == 1.0
    assert [p.completed for p in m.per_replica] == [4, 4]
    assert m.to_dict()["policy"] == "round_robin"


def test_fleet_fault_isolation(lm):
    """Under a NaN plan each replica keeps its own schedule: the fleet
    equals the single replicas with the same derived injectors, and the
    replicas fire on different events."""
    fleet, _ = _fleet_parity(lm, fault_plan="nan_logits=0.3,seed=5")
    stats = [rep.injector.stats() for rep in fleet.replicas]
    assert sum(s["nan_logits"] for s in stats) > 0


@pytest.mark.parametrize("policy", ["least_queue", "ttft_aware"])
def test_policies_complete_a_bursty_trace(lm, policy):
    reqs = make_trace(10, mean_in=10, mean_out=6, rate=8.0,
                      vocab=lm["cfg"].vocab_size, seed=3)
    fleet = TR.Router([build_replica(RS, ap=lm["ap"], model=lm["model"],
                                     device="cpu") for _ in range(2)],
                      policy=policy, cost_fn=TR.prefill_cost_model(RS))
    done = fleet.run(_copy(reqs))
    assert fleet.metrics(done).fleet.completed == len(reqs)
    assert all(p > 0 for p in fleet.placements), fleet.placements


def test_from_spec_shares_weights_and_runs_disagg_replicas(lm):
    """``Router.from_spec`` builds every replica of the template on the one
    device, replica 0's weights serving the others; a fleet of
    disaggregated replicas merges its ``DisaggMetrics``."""
    spec = ServeSpec(replica=RS.replace(disagg=True, block_size=8),
                     replicas=2)
    fleet = TR.Router.from_spec(spec, ap=lm["ap"], model=lm["model"],
                                device="cpu")
    a, b = fleet.replicas
    assert b.prefill.model is a.prefill.model
    assert b.decode.model is a.decode.model
    assert a.prefill.mesh is None and b.decode.mesh is None
    reqs = make_trace(6, mean_in=10, mean_out=5, rate=3.0,
                      vocab=lm["cfg"].vocab_size, seed=1)
    done = fleet.run(_copy(reqs))
    m = fleet.metrics(done)
    assert isinstance(m.fleet, DisaggMetrics)
    assert m.fleet.completed == 6 and m.fleet.handoffs == 6


def test_serve_metrics_merge_is_lossless(lm):
    parts = []
    for seed in (2, 3):
        sched = build_replica(RS, ap=lm["ap"], model=lm["model"],
                              device="cpu")
        done = sched.run(make_trace(5, mean_in=10, mean_out=6, rate=3.0,
                                    vocab=lm["cfg"].vocab_size, seed=seed))
        parts.append(sched.metrics(done))
    fleet = ServeMetrics.merge(parts)
    ttft = [s for m in parts for s in m.ttft_steps_samples]
    assert len(ttft) == 10 and fleet.completed == 10
    assert fleet.total_new_tokens == sum(m.total_new_tokens for m in parts)
    assert fleet.ttft_steps_p99 == pytest.approx(
        float(np.percentile(np.asarray(ttft, np.float64), 99)))
    again = ServeMetrics.merge([fleet])
    assert again.ttft_steps_p99 == fleet.ttft_steps_p99
    assert "ttft_steps_samples" not in fleet.to_dict()
    with pytest.raises(ValueError):
        ServeMetrics.merge([])


@pytest.mark.parametrize("policy", ["round_robin", "ttft_aware"])
def test_serve_cli_router(capsys, policy):
    done, rm = serve.main(["--mode", "trace", "--device", "cpu",
                           "--n-requests", "6", "--replicas", "2",
                           "--router-policy", policy,
                           "--fault-plan", "seed=2,nan_logits=0.1"])
    assert rm.fleet.completed == 6 and sum(rm.placements) == 6
    out = capsys.readouterr().out
    assert f"[2x local policy={policy}]" in out and "replica 1" in out


def test_serve_cli_refuses_like_validate():
    for argv, frag in (
            (["--mode", "batch", "--fault-plan", "oom=0.1"],
             "trace-mode only"),
            (["--mode", "trace", "--ar-quant", "auto"], "ar_strategy"),
            (["--mode", "trace", "--prefix-cache", "on"], "paged"),
            (["--mode", "trace", "--disagg", "--decode-tp", "6",
              "--decode-pods", "4"], "divisible"),
            (["--mode", "trace", "--admit-mode", "chunked", "--s-max",
              "100", "--admit-chunk", "32"], "admit_chunk")):
        with pytest.raises(SystemExit, match=frag):
            serve.main(["--device", "cpu", *argv])
