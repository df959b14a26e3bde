"""The port's quantized all-reduce wire (``ar_quant`` int8/int4 with error
feedback, and the legacy ``compress_slow`` / ``quant_ag`` knobs) over the
virtual mesh, held against the JAX package's ``core/hierarchical.py``
under nested ``jax.vmap`` (the rank-batched picture of its ``shard_map``
code), and the quantized branches of the port's ``core/overlap.py``.

The JAX side of each mesh layout is traced once, in one jitted function,
and compiled without XLA's algebraic simplifier, which rewrites the
reference's division of the group's absmax by the constant qmax into a
multiply by 1/qmax: that changes the scale's last bit in about half of
the groups and flips a rounding at near-ties, so the compiled function
would differ from the reference's own eager (IEEE) arithmetic, the
contract the port's kernel and plain version follow.  Then the port
equals JAX bitwise wherever every sum has at most two terms, and within
one quantization step where a sum of more terms may be taken in another
order."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import hierarchical as JH  # noqa: E402
from repro.core.pcontext import ParallelCtx as JCtx  # noqa: E402
from repro_torch.core import hierarchical as TH  # noqa: E402
from repro_torch.core import overlap as TO  # noqa: E402
from repro_torch.core.mesh import VirtualMesh  # noqa: E402
from repro_torch.core.pcontext import ParallelCtx as TCtx  # noqa: E402
from repro_torch.kernels import kernel_wrappers  # noqa: E402
from repro_torch.kernels.quant_pack import GROUP_CAP, QMAX  # noqa: E402

torch.set_num_threads(1)

STRATEGIES = ("flat", "hier_ring", "hier_rd", "hier_rd_halving")
LAYOUTS = ((1, 4), (2, 2), (4, 2))
QUANTS = ("int8", "int4")
COMPILE = {"xla_disable_hlo_passes": "algsimp",
           "xla_backend_optimization_level": 0,
           "xla_llvm_disable_expensive_passes": True}
# per-rank inputs: the all-reduce message (B, 1, D) and its EF residue;
# a (4, 3, 33) tensor scattered and gathered on dim 0 (an odd trailing dim
# takes the int4 padding branch); a (2, 1, 64) shard for the all-gathers
AR_SHAPE, ODD_SHAPE, SHARD_SHAPE = (3, 1, 256), (4, 3, 33), (2, 1, 64)


def _wiring(pods, strategy, **kw):
    return dict(tp_fast=("model",), tp_slow=("pod",) if pods > 1 else (),
                ar_strategy=strategy, **kw)


def _inputs(layout):
    rng = np.random.default_rng(sum(layout))
    x = rng.standard_normal(layout + AR_SHAPE).astype(np.float32)
    return {"x": x,
            "ef": (0.01 * rng.standard_normal(x.shape)).astype(np.float32),
            "odd": rng.standard_normal(layout + ODD_SHAPE).astype(np.float32),
            "shard": rng.standard_normal(layout + SHARD_SHAPE)
            .astype(np.float32)}


def _cases(pods):
    """(key, ctx kwargs, what) for every JAX call of a layout."""
    out = []
    for q in QUANTS:
        for s in STRATEGIES:
            out.append((f"ar/{q}/{s}", _wiring(pods, s, ar_quant=q), "ar"))
        for s in ("flat", "hier_rd"):
            out.append((f"rs/{q}/{s}", _wiring(pods, s, ar_quant=q), "rs"))
        out.append((f"ag/{q}", _wiring(pods, "hier_rd", ar_quant=q), "ag"))
    out.append(("compress", _wiring(pods, "hier_rd", compress_slow=True),
                "ar"))
    for s in ("flat", "hier_rd"):
        out.append((f"quant_ag/{s}", _wiring(pods, s, quant_ag=True), "ar"))
    return out


@functools.lru_cache(maxsize=None)
def _jax_results(layout):
    """Every JAX output the tests compare with, for one (pods, fast)
    layout, in one compiled function."""
    pods, _ = layout
    data = _inputs(layout)

    def per_rank(d):
        res = {}
        for key, kw, what in _cases(pods):
            ctx = JCtx(**kw)
            if what == "ar":
                res[key] = JH.tp_all_reduce(d["x"], ctx, scatter_dim=-1)
                if key.startswith("ar/"):
                    res[key + "/y_ef"], res[key + "/ef"] = JH.tp_all_reduce(
                        d["x"], ctx, scatter_dim=-1, ef=d["ef"])
            elif what == "rs":
                res[key + "/-1"] = JH.tp_reduce_scatter(d["x"], ctx, dim=-1)
                res[key + "/0"] = JH.tp_reduce_scatter(d["odd"], ctx, dim=0)
            else:
                res[key + "/-1"] = JH.tp_all_gather(d["shard"], ctx, dim=-1)
                res[key + "/0"] = JH.tp_all_gather(d["odd"], ctx, dim=0)
        return res

    f = jax.jit(jax.vmap(jax.vmap(per_rank, axis_name="model"),
                         axis_name="pod"))
    res = f.lower(data).compile(compiler_options=COMPILE)(data)
    return jax.tree.map(np.asarray, res)


def _port(layout, name):
    a = _inputs(layout)[name]
    return torch.tensor(a.reshape(layout[0] * layout[1], *a.shape[2:]))


def _want(layout, key):
    v = _jax_results(layout)[key]
    return v.reshape(layout[0] * layout[1], *v.shape[2:])


def _terms(pods, fast, strategy):
    """The most terms any one sum of the quantized all-reduce adds: the n
    dequantized pieces of a reduce-scatter stage, 2 in a recursive-
    doubling step, the pods in the bf16 slow sum of hier_ring."""
    stages = (pods, fast) if strategy == "flat" else (fast,)
    slow = pods if strategy == "hier_ring" else min(pods, 2)
    return max(*stages, slow)


def _within_one_step(got, want, bits, bf16_sum=False):
    """|got - want| within one quantization step of the (cap-wide, so at
    least as coarse as any group's) window each element lies in, plus,
    where the wire sums in bf16 (hier_ring's slow phase), the bf16
    roundings of a sum taken in another order."""
    cap = GROUP_CAP[bits]
    w = want.reshape(*want.shape[:-1], -1, cap)
    step = np.abs(w).max(-1, keepdims=True) / QMAX[bits]
    if bf16_sum:
        step = step + 2.0 ** -7 * np.abs(w)
    diff = np.abs(got.reshape(w.shape) - w)
    assert np.all(diff <= 1.01 * step + 1e-6), (diff - step).max()


def _rows_identical(t):
    return all(torch.equal(t[0], t[r]) for r in range(1, t.shape[0]))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("quant", QUANTS)
def test_quant_tp_all_reduce_matches_jax(quant, strategy, layout):
    """With and without error feedback: y bitwise where every sum has at
    most two terms (else within one quantization step), the returned EF
    bitwise, every rank holding the same y, and no launch on the CPU."""
    pods, fast = layout
    mesh = VirtualMesh(pods, fast, device="cpu")
    ctx = TCtx(**_wiring(pods, strategy, ar_quant=quant))
    x, ef = _port(layout, "x"), _port(layout, "ef")
    before = [w.launches for w in kernel_wrappers()]
    got = TH.tp_all_reduce(x, ctx, mesh)
    got_ef, new_ef = TH.tp_all_reduce(x, ctx, mesh, ef=ef)
    assert [w.launches for w in kernel_wrappers()] == before
    key = f"ar/{quant}/{strategy}"
    bits = TH.QUANT_BITS[quant]
    for y, w in ((got, _want(layout, key)),
                 (got_ef, _want(layout, key + "/y_ef"))):
        assert y.shape == w.shape and y.dtype == torch.float32
        if _terms(pods, fast, strategy) <= 2:
            np.testing.assert_array_equal(y.numpy(), w)
        else:
            _within_one_step(y.numpy(), w, bits,
                             bf16_sum=strategy == "hier_ring")
        assert _rows_identical(y)
    np.testing.assert_array_equal(new_ef.numpy(), _want(layout, key + "/ef"))
    assert new_ef.dtype == torch.float32 and new_ef.abs().max() > 0


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("quant", QUANTS)
def test_quant_reduce_scatter_and_all_gather_match_jax(quant, layout):
    """The packed reduce-scatter (trailing dim; dim 0 with an odd trailing
    dim) under flat and hier_rd, and the packed all-gather on both dims."""
    pods, fast = layout
    mesh = VirtualMesh(pods, fast, device="cpu")
    for strategy in ("flat", "hier_rd"):
        ctx = TCtx(**_wiring(pods, strategy, ar_quant=quant))
        # the fast pieces, then the pods: in bf16 under flat, in the
        # 2-term quantized doubling steps under hier_rd
        terms = max(fast, pods if strategy == "flat" else min(pods, 2))
        for dim, name in ((-1, "x"), (0, "odd")):
            got = TH.tp_reduce_scatter(_port(layout, name), ctx, mesh,
                                       dim=dim)
            want = _want(layout, f"rs/{quant}/{strategy}/{dim}")
            assert got.shape == want.shape
            if terms <= 2:
                np.testing.assert_array_equal(got.numpy(), want)
            else:   # bf16 sums of more terms, rounded in another order
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=2.0 ** -6 * np.abs(want).max())
    ctx = TCtx(**_wiring(pods, "hier_rd", ar_quant=quant))
    for dim, name in ((-1, "shard"), (0, "odd")):
        got = TH.tp_all_gather(_port(layout, name), ctx, mesh, dim=dim)
        np.testing.assert_array_equal(got.numpy(),
                                      _want(layout, f"ag/{quant}/{dim}"))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("knob", ["compress", "quant_ag/flat",
                                  "quant_ag/hier_rd"])
def test_legacy_int8_knobs_match_jax(knob, layout):
    """``compress_slow`` (int8 recursive doubling, each rank keeping its
    own unquantized accumulator) and ``quant_ag`` (int8 all-gather after
    a full-precision reduce-scatter) through the same kernels at bits 8,
    group 128."""
    pods, fast = layout
    kw = dict(compress_slow=True) if knob == "compress" \
        else dict(quant_ag=True)
    strategy = "hier_rd" if knob != "quant_ag/flat" else "flat"
    ctx = TCtx(**_wiring(pods, strategy, **kw))
    got = TH.tp_all_reduce(_port(layout, "x"), ctx,
                           VirtualMesh(pods, fast, device="cpu"))
    want = _want(layout, knob)
    if fast <= 2:
        np.testing.assert_array_equal(got.numpy(), want)
    else:                       # a 4-term fast sum in another order
        _within_one_step(got.numpy(), want, 8)


# ---------------------------------------------------------------------------
# The quantized overlapped projection
# ---------------------------------------------------------------------------


def _case_b(quant):
    """The reference's case B (tests/dist_cases/case_quant_ar.py): x
    (4, 1, 256) and w (256, 4096) cut over 2 pods x 4 ranks along the
    contraction, so the per-rank output (4, 1, 4096) splits into 4
    chunks of 1024, a multiple of the group cap times the 8 ranks."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 1, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 4096)) * 0.05).astype(np.float32)
    xr = torch.tensor(x.reshape(4, 1, 8, 32).transpose(2, 0, 1, 3).copy())
    wr = torch.tensor(w.reshape(8, 32, 4096))
    ctx = TCtx(**_wiring(2, "hier_rd", ar_quant=quant, overlap_matmul=True))
    return xr, wr, ctx, VirtualMesh(2, 4, device="cpu")


@pytest.mark.parametrize("quant", QUANTS)
def test_quant_collective_matmul_is_bitwise_chunk_invariant(quant):
    """y and EF of the chunked quantized projection equal the unchunked
    ones bitwise (the invariant the reference states for case B; its own
    run breaks it in EF, ROADMAP section 3), and EF is captured."""
    x, w, ctx, mesh = _case_b(quant)
    ef0 = torch.zeros(8, 4, 1, 4096)
    assert TO._quant_chunk_ok(4096, 4, 8, TH.QUANT_BITS[quant])
    y1, e1 = TO.collective_matmul(x, w, ctx, mesh, chunks=1, ef=ef0)
    y4, e4 = TO.collective_matmul(x, w, ctx, mesh, chunks=4, ef=ef0)
    assert torch.equal(y1, y4) and torch.equal(e1, e4)
    assert e1.abs().max() > 0
    y, e = TH.tp_all_reduce(TO.project(x, w), ctx, mesh, ef=ef0)
    assert torch.equal(y1, y) and torch.equal(e1, e)
    # a misaligned chunk keeps one message (int8: 4096 / 8 = 512 < 1024)
    assert TO._quant_chunk_ok(4096, 8, 8, 8) is False


def test_fused_kernel_only_on_an_unquantized_wire(monkeypatch):
    """Kernel 5's form runs only when the resolved ctx has no quantized
    level, neither legacy int8 knob, and no EF enters the reduction: a
    quantized or EF-consuming projection takes the chunk loop (same y and
    EF as the lax backend), while an unquantized call given EF reduces
    without it and hands EF back untouched."""
    x, w, ctx, mesh = _case_b("int8")
    calls = []
    real = TO._fused_rd
    monkeypatch.setattr(TO, "_fused_rd",
                        lambda *a: calls.append(1) or real(*a))
    ef0 = torch.full((8, 4, 1, 4096), 0.01)
    for kw in (dict(ar_quant="int8"), dict(ar_quant="int4"),
               dict(ar_quant="none", compress_slow=True),
               dict(ar_quant="none", quant_ag=True)):
        c = ctx.replace(**kw)
        for ef in (None, ef0):
            fused = TO.collective_matmul(x, w, c, mesh, ef=ef)
            lax = TO.collective_matmul(x, w, c, mesh, ef=ef, backend="lax")
            if ef is None:
                fused, lax = (fused,), (lax,)
            assert all(torch.equal(a, b) for a, b in zip(fused, lax))
    assert calls == []
    y, e = TO.collective_matmul(x, w, ctx.replace(ar_quant="none"), mesh,
                                ef=ef0)
    assert calls == [1] and e is ef0
    assert torch.equal(y, TO.collective_matmul(
        x, w, ctx.replace(ar_quant="none"), mesh))
