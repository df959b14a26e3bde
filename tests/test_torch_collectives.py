"""The port's TP collectives over the virtual mesh held against the JAX
package's ``core/hierarchical.py``, run under nested ``jax.vmap`` with the
mesh's axis names (the same rank-batched picture as the port's leading
rank axis, rank = pod * fast + f), plus the recursive-doubling schedule's
properties and the knobs left for later slices (``auto`` and
``overlap_matmul`` run since they were ported: tests/test_torch_overlap.py
and tests/test_torch_autotune.py; the quantized wire:
tests/test_torch_quant.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pure-pytest fallback (requirements-dev.txt)
    from _hypothesis_fallback import given, settings, st

from repro.core import hierarchical as JH  # noqa: E402
from repro.core.pcontext import ParallelCtx as JCtx  # noqa: E402
from repro_torch.core import hierarchical as TH  # noqa: E402
from repro_torch.core.mesh import VirtualMesh, mesh_and_ctx  # noqa: E402
from repro_torch.core.pcontext import ParallelCtx as TCtx  # noqa: E402
from repro_torch.kernels import rd_allreduce as rdk  # noqa: E402

torch.set_num_threads(1)

STRATEGIES = ("flat", "hier_ring", "hier_rd", "hier_rd_halving")
LAYOUTS = ((1, 4), (2, 1), (2, 2), (4, 2))
# f32: both sides add the same numbers, possibly in another order (the
# fast sums of up to 4 ranks).  bf16: one rounding per add, 2^-8 relative.
ATOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _ctxs(strategy, **kw):
    wiring = dict(tp_fast=("model",), tp_slow=("pod",), ar_strategy=strategy,
                  rd_chunks=2, **kw)
    return JCtx(**wiring), TCtx(**wiring)


def _vmapped(fn, pods_axis=True):
    """fn over one rank's array, vmapped over model, then pod."""
    inner = jax.vmap(fn, axis_name="model")
    return jax.vmap(inner, axis_name="pod") if pods_axis else inner


def _data(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _rows_identical(t):
    return all(torch.equal(t[0], t[r]) for r in range(1, t.shape[0]))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("pods", [1, 2, 3, 4, 8])
def test_rd_plain_matches_jax_rd_all_reduce(pods, chunks, dt):
    """P = 3 takes the reference's psum dispatch, P = 1 its identity."""
    x = _data((pods, 5, 7), seed=pods)
    want = jax.vmap(lambda v: JH.rd_all_reduce(v, "pod", chunks=chunks),
                    axis_name="pod")(jnp.asarray(x, getattr(jnp, dt)))
    before = rdk.rd_all_reduce.launches
    got = rdk.rd_all_reduce(torch.tensor(x).to(getattr(torch, dt)), pods,
                            n_chunks=chunks)
    assert rdk.rd_all_reduce.launches == before     # plain version on CPU
    assert got.shape == x.shape and got.dtype == getattr(torch, dt)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=ATOL[dt])
    assert _rows_identical(got)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_tp_all_reduce_matches_jax(strategy, layout):
    pods, fast = layout
    jctx, tctx = _ctxs(strategy)
    x = _data((pods, fast, 3, 8), seed=7)
    want = _vmapped(lambda v: JH.tp_all_reduce(v, jctx, scatter_dim=-1))(x)
    mesh = VirtualMesh(pods, fast, device="cpu")
    got = TH.tp_all_reduce(torch.tensor(x).reshape(pods * fast, 3, 8), tctx,
                           mesh, scatter_dim=-1)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(got.shape),
                               atol=ATOL["float32"])
    assert _rows_identical(got)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("strategy", ["flat", "hier_rd"])
def test_tp_reduce_scatter_matches_jax(strategy, layout):
    pods, fast = layout
    jctx, tctx = _ctxs(strategy)
    x = _data((pods, fast, 4, 6), seed=8)
    want = _vmapped(lambda v: JH.tp_reduce_scatter(v, jctx, dim=0))(x)
    got = TH.tp_reduce_scatter(torch.tensor(x).reshape(pods * fast, 4, 6),
                               tctx, VirtualMesh(pods, fast, device="cpu"),
                               dim=0)
    assert got.shape == (pods * fast, 4 // fast, 6)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(got.shape),
                               atol=ATOL["float32"])


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
def test_tp_all_gather_matches_jax(layout):
    pods, fast = layout
    jctx, tctx = _ctxs("hier_rd")
    x = _data((pods, fast, 3, 5), seed=9)
    want = _vmapped(lambda v: JH.tp_all_gather(v, jctx, dim=-1))(x)
    got = TH.tp_all_gather(torch.tensor(x).reshape(pods * fast, 3, 5), tctx,
                           VirtualMesh(pods, fast, device="cpu"), dim=-1)
    assert got.shape == (pods * fast, 3, 5 * fast)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(got.shape))


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    x = torch.tensor(_data((8, 2, 64), seed=3))
    before = rdk.rd_all_reduce.launches
    got = rdk.rd_all_reduce(x, 4, n_chunks=2,
                            workspace=rdk.RDWorkspace())
    assert torch.equal(got, rdk.rd_all_reduce_ref(x, 4, n_chunks=2))
    assert rdk.rd_all_reduce.launches == before
    assert rdk.rd_all_reduce(x, 1) is x              # one pod: identity
    with pytest.raises(ValueError, match="pods=3"):
        rdk.rd_all_reduce(x, 3)                      # 8 ranks, 3 pods
    # CTA pieces: ~2 vectors a thread, never more than stay resident
    assert rdk.rd_pieces(1024, 8, 1, 1056) == 2      # the decode message
    assert rdk.rd_pieces(2**19, 8, 1, 1056) == 132   # the prefill message
    assert rdk.rd_pieces(2**19, 8, 4, 1056) == 33
    with pytest.raises(ValueError, match="resident"):
        rdk.rd_pieces(64, 16, 100, 1056)


@pytest.mark.parametrize("protocol", ["ll", "simple"])
def test_cpu_wrapper_launches_nothing_under_a_forced_protocol(protocol,
                                                              monkeypatch):
    """Forcing a protocol changes nothing on the CPU: the plain version,
    no launch, whatever the message size."""
    monkeypatch.setattr(rdk.ops, "PROTOCOL", protocol)
    before = rdk.rd_all_reduce.launches
    for shape in ((8, 2, 64), (4, 4097)):
        x = torch.tensor(_data(shape, seed=5))
        got = rdk.rd_all_reduce(x, 4, workspace=rdk.RDWorkspace())
        assert torch.equal(got, rdk.rd_all_reduce_ref(x, 4))
    assert rdk.rd_all_reduce.launches == before


@pytest.mark.parametrize("nbytes,want", [
    (16 * 2**10, "ll"),                  # the llama tp=8 decode message
    (rdk.LL_MAX_BYTES, "ll"), (rdk.LL_MAX_BYTES + 2, "simple"),
    (8 * 2**20, "simple"),               # the llama tp=8 prefill message
])
def test_rd_protocol_by_size(nbytes, want, monkeypatch):
    """LL packets up to the crossover, pieces and flags above it; the
    module attribute forces either, whatever the size."""
    assert rdk.rd_protocol(nbytes) == want
    for forced in ("ll", "simple"):
        monkeypatch.setattr(rdk.ops, "PROTOCOL", forced)
        assert rdk.rd_protocol(nbytes) == forced
    monkeypatch.setattr(rdk.ops, "PROTOCOL", "fast")
    with pytest.raises(ValueError, match="PROTOCOL"):
        rdk.rd_protocol(nbytes)


def test_ll_packets_and_receive_buffers():
    """An 8-byte packet carries 4 data bytes (two bf16 or one f32, the last
    one padded), so a step's receive buffer is twice the payload, one
    buffer a step.  A rank's packets go to CTAs of the fewest packets a
    thread (1, 2 or 4) that cover them in one round of resident CTAs,
    else to as many CTAs of 4 a thread as stay resident."""
    assert rdk.ll_packets(8192, 2) == 4096           # 16 KB of bf16
    assert rdk.ll_packets(4097, 2) == 2049           # odd: last one padded
    assert rdk.ll_packets(4097, 4) == 4097
    for steps, R, m, esz in ((2, 8, 8192, 2), (3, 16, 2**20, 4),
                             (1, 2, 4096, 2)):
        assert rdk.ll_recv_bytes(steps, R, m, esz) == 2 * steps * R * m * esz
    assert rdk.ll_recv_bytes(1, 2, 4097, 2) == 2 * 2049 * 8
    assert rdk.ll_plan(4096, 8, 1056) == (16, 1)     # the decode message
    assert rdk.ll_plan(2**15, 8, 1056) == (128, 1)   # 128 KB of bf16
    assert rdk.ll_plan(2**15, 16, 1056) == (64, 2)   # ... on 16 ranks
    assert rdk.ll_plan(2**16, 16, 1056) == (64, 4)
    assert rdk.ll_plan(2**22, 8, 1056) == (132, 4)   # capped: rounds
    assert rdk.ll_plan(10, 8, 1056) == (1, 1)
    with pytest.raises(ValueError, match="resident"):
        rdk.ll_plan(64, 16, 8)


def test_workspace_holds_the_epoch():
    """The kernel's epochs live in the workspace: 8 words a device, 128
    bytes apart, each int32 [ticket, epoch] read as one 64-bit word
    (epoch << 32) | ticket, the epoch starting at 1 (flags and packets
    start at 0); the LL buffer starts zeroed and only grows; the fused
    kernel has epoch words of its own, apart from kernel 4's."""
    ws = rdk.RDWorkspace()
    dev = torch.device("cpu")
    ctl = ws.control(dev)
    assert ctl.dtype == torch.int32 and ctl.shape == (8, 32)
    assert ctl.element_size() * ctl.stride(0) == 128
    words = ctl[:, :2].contiguous().view(torch.int64).flatten()
    assert words.tolist() == [1 << 32] * 8
    assert not ctl[:, 2:].any()
    assert ws.control(dev) is ctl
    buf = ws.ll_buffer(dev, 4096)
    assert buf.numel() == 4096 and not buf.any()
    assert ws.ll_buffer(dev, 1024) is buf
    assert ws.ll_buffer(dev, 8192).numel() == 8192
    assert ws.nbytes == 8 * 128 + 8192
    fused = ws.control(dev, kernel="fused_matmul_rd")
    assert fused is not ctl and torch.equal(fused, ctl)
    assert ws.control(dev, kernel="fused_matmul_rd") is fused
    assert ws.nbytes == 2 * 8 * 128 + 8192
    assert not hasattr(ws, "next_seq")


def test_workspace_generation_moves_when_a_captured_buffer_grows(
        monkeypatch):
    """A buffer a CUDA-graph capture took and a later eager call grows
    moves ``generation`` on (once for all buffers grown before the next
    capture), so a captured step is captured anew; growing a buffer no
    capture took leaves it, and growing one during a capture raises.  The
    capture is simulated on CPU tensors through ``_capturing``."""
    ws = rdk.RDWorkspace()
    dev = torch.device("cpu")
    capturing = [False]

    def fake(device, refuse=""):
        if capturing[0] and refuse:
            raise RuntimeError(f"RDWorkspace: {refuse} would be allocated "
                               "while a CUDA graph is captured")
        return capturing[0]

    monkeypatch.setattr(rdk.RDWorkspace, "_capturing", staticmethod(fake))
    recv, flags = ws.buffers(dev, 1024, 16, kernel="fused_matmul_rd")
    ll = ws.ll_buffer(dev, 512)
    capturing[0] = True                       # the capture takes both
    assert ws.buffers(dev, 512, 8, kernel="fused_matmul_rd") == (recv,
                                                                 flags)
    assert ws.ll_buffer(dev, 256) is ll
    with pytest.raises(RuntimeError, match="captured"):
        ws.buffers(dev, 2048, 16, kernel="fused_matmul_rd")
    capturing[0] = False
    assert ws.generation == 0
    ws.buffers(dev, 4096, 64)                  # kernel 4's: not taken
    ws.buffers(dev, 8192, 64)
    assert ws.generation == 0
    recv2, flags2 = ws.buffers(dev, 2048, 16, kernel="fused_matmul_rd")
    assert recv2 is not recv and recv2.numel() == 2048 and flags2 is flags
    assert ws.generation == 1
    assert ws.ll_buffer(dev, 1024) is not ll   # same capture: no second move
    assert ws.generation == 1
    capturing[0] = True                        # captured anew
    ll = ws.ll_buffer(dev, 1024)
    capturing[0] = False
    assert ws.ll_buffer(dev, 4096) is not ll and ws.generation == 2


@pytest.mark.parametrize("knob,item", [
    (dict(ar_quant="int8"), None),
    (dict(compress_slow=True), None),
    (dict(seq_parallel="on"), "item 9"),
], ids=["ar_quant", "compress_slow", "seq_parallel"])
def test_knobs_left_for_later_raise(knob, item):
    """Only ``seq_parallel`` is left for a later slice and raises; the
    quantized wire's knobs run: within their int8 rounding of the exact
    sum, every rank holding the same sum under ``ar_quant`` (the legacy
    ``compress_slow`` lets XOR peers differ by a rounding, as in the
    reference)."""
    kw = dict(ar_strategy="hier_rd")
    kw.update(knob)
    ctx = TCtx(tp_fast=("model",), tp_slow=("pod",), **kw)
    mesh = VirtualMesh(2, 2, device="cpu")
    x = torch.tensor(_data((4, 2, 8), seed=4))
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            TH.tp_all_reduce(x, ctx, mesh)
        return
    got = TH.tp_all_reduce(x, ctx, mesh)
    exact = x.sum(0, keepdim=True).expand_as(x)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=0.05)
    assert not torch.equal(got, exact)              # it did quantize
    assert _rows_identical(got) == ("ar_quant" in knob)


def test_mesh_checks_its_ctx():
    mesh, ctx = mesh_and_ctx(8, 4, ar_strategy="hier_rd", device="cpu")
    assert (mesh.pods, mesh.fast, mesh.size) == (4, 2, 8)
    assert ctx.tp_slow == ("pod",) and ctx.tp_fast == ("model",)
    assert [mesh.coords(mesh.rank(p, f)) for p in range(4) for f in range(2)] \
        == [(p, f) for p in range(4) for f in range(2)]
    mesh.check_ctx(ctx)
    with pytest.raises(ValueError, match="not a TP axis"):
        mesh.check_ctx(ctx.replace(tp_slow=()))
    with pytest.raises(ValueError, match="not the mesh's"):
        mesh.check_ctx(ctx.replace(tp_fast=("data",)))
    with pytest.raises(NotImplementedError, match="one slow and one fast"):
        mesh.check_ctx(ctx.replace(tp_fast=("model", "data")))
    assert mesh_and_ctx(1)[0] is None


@given(st.sampled_from([2, 4, 8, 16]))
@settings(deadline=None, max_examples=4)
def test_port_xor_schedule_is_perfect_matching_each_step(n):
    """The port's peer index at every step is an involution without fixed
    points: each rank exchanges with exactly one other."""
    ranks = torch.arange(n)
    step = 1
    while step < n:
        peers = rdk.ref.xor_peers(n, step)
        assert not torch.any(peers == ranks)
        assert torch.equal(peers[peers], ranks)
        step <<= 1


@given(st.sampled_from([2, 4, 8, 16]))
@settings(deadline=None, max_examples=4)
def test_port_rd_converges_to_full_sum(n):
    """After log2(n) XOR steps of the port's plain RD every rank holds the
    sum over the pods, column by column of a 2-wide fast axis."""
    x = torch.tensor(np.random.default_rng(n).standard_normal((2 * n, 3)),
                     dtype=torch.float64)
    got = rdk.rd_all_reduce_ref(x, n)
    want = x.reshape(n, 2, 3).sum(0)
    for p in range(n):
        torch.testing.assert_close(got.reshape(n, 2, 3)[p], want,
                                   rtol=1e-12, atol=1e-12)
