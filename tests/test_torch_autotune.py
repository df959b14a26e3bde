"""The port's all-reduce autotuner (``repro_torch/core/autotune.py`` over
its own ``comm_model.py``) held against the JAX package's: the same
predictions and picks over a grid of message sizes, topologies, dtypes
and networks, tables that load across the two packages with the same
choices, the same measurement refinement, and the port's own dispatch
keys (the reference's dtype names) and per-step tuner capture."""
import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import autotune as JA  # noqa: E402
from repro.core import comm_model as JCM  # noqa: E402
from repro_torch.core import autotune as TA  # noqa: E402
from repro_torch.core import comm_model as TCM  # noqa: E402
from repro_torch.core import hierarchical as TH  # noqa: E402
from repro_torch.core.mesh import VirtualMesh, mesh_and_ctx  # noqa: E402
from repro_torch.core.pcontext import ParallelCtx as TCtx  # noqa: E402

torch.set_num_threads(1)

NETS = ("perlmutter", "vista", "tpu_v5e")
LAYOUTS = ((1, 2), (2, 2), (2, 4), (4, 2))     # (fast, slow)
# 1 KB to 64 MB: every power of two, and sizes between them
SIZES = [2 ** p for p in range(10, 27)] + [3 * 2 ** p for p in range(9, 25)] \
    + [1000, 12345, 33000, 5_000_000]


def _tuners(net):
    return JA.AutoTuner(JCM.NETWORKS[net]), TA.AutoTuner(TCM.NETWORKS[net])


def test_networks_are_the_references():
    assert TCM.NETWORKS.keys() == JCM.NETWORKS.keys()
    for name, net in TCM.NETWORKS.items():
        assert dataclasses.asdict(net) == dataclasses.asdict(
            JCM.NETWORKS[name])
    assert TA.AutoTuner().net is TCM.PERLMUTTER       # the port's default


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"f{v[0]}s{v[1]}")
@pytest.mark.parametrize("net", NETS)
def test_choices_match_jax(net, layout, dtype):
    fast, slow = layout
    jt, tt = _tuners(net)
    for b in SIZES:
        assert TA.predict_times(b, fast, slow, tt.net) == \
            JA.predict_times(b, fast, slow, jt.net)
        want = dataclasses.asdict(jt.choose(b, fast, slow, dtype))
        assert dataclasses.asdict(tt.choose(b, fast, slow, dtype)) == want, b
    assert tt.lookups == jt.lookups
    assert tt.to_json()["table"] == jt.to_json()["table"]


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_tables_load_across_packages(saver, tmp_path):
    """A table saved by either package (refined by measurements, so it is
    more than the analytic seed) loads in the other with the same choices
    for every key."""
    jt, tt = _tuners("perlmutter")
    for t in (jt, tt):
        for b in SIZES:
            for dt in ("bfloat16", "float32"):
                t.choose(b, 2, 4, dt)
        t.record(32768, 2, 4, "bfloat16", "flat", 1e-6)
        t.record(32768, 2, 4, "bfloat16", "hier_rd", 2e-6)
        t.record(2 ** 24, 2, 4, "bfloat16", "hier_rd", 1e-3)
        t.record(2 ** 24, 2, 4, "bfloat16", "hier_ring", 2e-3)
        assert t.refine() == 2
    assert tt.to_json() == jt.to_json()
    path = str(tmp_path / "table.json")
    (jt if saver == "jax" else tt).save(path)
    other = (TA if saver == "jax" else JA).AutoTuner.load(path)
    assert other.net.name == "perlmutter"
    assert {k: dataclasses.asdict(v) for k, v in other.table.items()} == \
        {k: dataclasses.asdict(v) for k, v in jt.table.items()}
    for b in SIZES:
        assert dataclasses.asdict(other.choose(b, 2, 4, "bfloat16")) == \
            dataclasses.asdict(jt.choose(b, 2, 4, "bfloat16"))
    assert other.choose(32768, 2, 4, "bfloat16").strategy == "flat"


def test_corrupt_table_degrades_to_the_port_default(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.warns(RuntimeWarning, match="unusable"):
        t = TA.AutoTuner.load(str(bad))
    assert t.net is TCM.PERLMUTTER and not t.table
    partly = tmp_path / "partly.json"
    partly.write_text(json.dumps({"version": 1, "net": "vista", "table": {
        "b15/f2/s4/bfloat16": {"strategy": "flat"},
        "b16/f2/s4/bfloat16": {"strategy": "nope"}}}))
    with pytest.warns(RuntimeWarning, match="dropped 1"):
        t = TA.AutoTuner.load(str(partly))
    assert t.net is TCM.VISTA and list(t.table) == ["b15/f2/s4/bfloat16"]


def test_dispatch_keys_use_the_references_dtype_names():
    """``tp_all_reduce`` under ``auto`` keys the active table on one rank's
    message bytes and the reference's dtype name, so the same call site
    hits the same entry as in the JAX package."""
    mesh, ctx = mesh_and_ctx(8, 4, ar_strategy="auto", device="cpu")
    tuner = TA.AutoTuner()
    for dt, name in ((torch.bfloat16, "bfloat16"),
                     (torch.float32, "float32")):
        x = torch.ones(8, 4, 1, 64, dtype=dt)
        with TA.using(tuner):
            y = TH.tp_all_reduce(x, ctx, mesh)
        assert torch.equal(y, torch.full_like(x, 8))
        b = 4 * 64 * x.element_size()
        assert tuner.lookups[f"b{JA.bucket_of(b)}/f2/s4/{name}"] == 1
    assert TH.dtype_name(torch.bfloat16) == "bfloat16"
    assert TA.active() is not tuner                   # restored


def test_resolved_ctx_runs_the_picked_strategy(monkeypatch):
    """A table entry decides what the call runs: forcing the decode
    bucket to ``hier_ring`` sends the slow phase to the plain sum, not the
    RD kernel's wrapper."""
    mesh, ctx = mesh_and_ctx(8, 4, ar_strategy="auto", device="cpu")
    x = torch.tensor(np.random.default_rng(0).standard_normal((8, 2, 16)),
                     dtype=torch.float32)
    calls = []
    monkeypatch.setattr(TH, "rd_all_reduce",
                        lambda *a, **k: calls.append(1) or a[0])
    tuner = TA.AutoTuner()
    with TA.using(tuner):
        TH.tp_all_reduce(x, ctx, mesh)
    assert calls == [1]                                # analytic: hier_rd
    tuner.record(2 * 16 * 4, 2, 4, "float32", "hier_ring", 1e-9)
    tuner.record(2 * 16 * 4, 2, 4, "float32", "hier_rd", 1e-3)
    tuner.refine()
    with TA.using(tuner):
        y = TH.tp_all_reduce(x, ctx, mesh)
    assert calls == [1]
    want = x.reshape(4, 2, 2, 16).sum((0, 1))
    np.testing.assert_allclose(y.numpy(), want.expand(8, 2, 16).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_quantized_dispatch_and_lossy_picks_raise():
    """Neither raises any more: an ``ar_quant`` policy keys its own
    namespace with the reference's pick, and a table entry that picks
    ``compress_slow`` runs the int8 slow exchange, the result a
    hier_rd + compress_slow ctx gives (not the full-precision sum)."""
    mesh = VirtualMesh(4, 2, device="cpu")
    tuner = TA.AutoTuner()
    got = tuner.choose(32768, 2, 4, "bfloat16", quant="auto")
    want = JA.AutoTuner(JCM.PERLMUTTER).choose(32768, 2, 4, "bfloat16",
                                               quant="auto")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert list(tuner.lookups) == [
        f"b{TA.bucket_of(32768)}/f2/s4/bfloat16:qauto"]
    ctx = TCtx(tp_fast=("model",), tp_slow=("pod",), ar_strategy="auto")
    lossy = TA.AutoTuner()
    x = torch.tensor(np.random.default_rng(1).standard_normal((8, 2, 16)),
                     dtype=torch.float32)
    lossy.table[f"b{TA.bucket_of(2 * 16 * 4)}/f2/s4/float32"] = \
        TA.ARChoice("hier_rd", compress_slow=True)
    with TA.using(lossy):
        y = TH.tp_all_reduce(x, ctx, mesh)
    forced = ctx.replace(ar_strategy="hier_rd", compress_slow=True)
    assert torch.equal(y, TH.tp_all_reduce(x, forced, mesh))
    assert not torch.equal(y, TH.tp_all_reduce(
        x, forced.replace(compress_slow=False), mesh))


def test_tuner_for_and_using(tmp_path, monkeypatch):
    t = TA.AutoTuner(TCM.VISTA)
    assert TA.tuner_for(t) is t
    monkeypatch.delenv("REPRO_AR_TABLE", raising=False)
    assert TA.tuner_for(None) is TA.active()
    path = tmp_path / "t.json"
    t.save(str(path))
    monkeypatch.setenv("REPRO_AR_TABLE", str(path))
    assert TA.tuner_for(None).net is TCM.VISTA
    prev = TA.active()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with TA.using(t):
            assert TA.active() is t
    assert TA.active() is prev
    assert TA.install(prev) is prev
