"""The quantized wire's fused kernels on the CPU: the plain versions of the
quantized recursive doubling in one launch
(``kernels/quant_rd_allreduce``), of the pack that also writes its
error-feedback residue, and of the unpack that reads strided views and
sums a piece dim (``kernels/quant_pack``), each held bitwise against the
JAX package's composition under nested ``jax.vmap``, compiled without
XLA's algebraic simplifier as ``tests/test_torch_quant_collectives.py``
explains; the unpack kernel's view geometry, replayed in Python over the
tensors' storage; the LL plan of the slow-phase kernel; and that none of
the wrappers launches anything on CPU tensors."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import hierarchical as JH  # noqa: E402
from repro.kernels.rd_allreduce import quant as JQ  # noqa: E402
from repro_torch.core import hierarchical as TH  # noqa: E402
from repro_torch.core.mesh import VirtualMesh  # noqa: E402
from repro_torch.core.pcontext import ParallelCtx as TCtx  # noqa: E402
from repro_torch.kernels import kernel_wrappers  # noqa: E402
from repro_torch.kernels import quant_pack as TQ  # noqa: E402
from repro_torch.kernels import quant_rd_allreduce as TR  # noqa: E402
from test_torch_quant_collectives import COMPILE  # noqa: E402

torch.set_num_threads(1)

LAYOUTS = ((2, 2), (4, 2))
BITS = (8, 4)
# one rank's slow-phase message: a whole number of 256-element tiles, and
# 300 (a partial tile: the kernel's zeros past m, the loop's padding)
SLOW_SHAPES = {"tiles": (2, 256), "ragged": (3, 100)}
# one rank's reduce-scatter message (B, 1, D), split over the fast axis
RS_SHAPE = (3, 1, 256)
# (bits, group, rows, D) of the pack with its residue
PACK_CASES = ((8, 128, 4, 512), (8, 1, 3, 64), (4, 64, 4, 384),
              (4, 2, 2, 96), (8, 16, 5, 48))


def _rank_inputs(layout):
    rng = np.random.default_rng(7 + sum(layout))
    data = {k: (rng.standard_normal(layout + s) * 3).astype(np.float32)
            for k, s in SLOW_SHAPES.items()}
    data["rs"] = rng.standard_normal(layout + RS_SHAPE).astype(np.float32)
    return data


@functools.lru_cache(maxsize=None)
def _jax_layout(layout):
    """The reference's slow phase and trailing-dim reduce-scatter
    composition (pack, ``lax.all_to_all``, unpack, sum) of every input of a
    layout, in one function compiled without the algebraic simplifier."""
    fast = layout[1]
    data = _rank_inputs(layout)

    def per_rank(d):
        res = {}
        for bits in BITS:
            for k in SLOW_SHAPES:
                res[f"slow/{bits}/{k}"] = JH.quant_rd_all_reduce(d[k], "pod",
                                                                 bits)
            v = d["rs"]
            shard = v.shape[-1] // fast
            group = JQ.group_for(shard, bits)
            q, s = JQ.quantize_pack(v.reshape(v.shape[:-1] + (fast, shard)),
                                    bits, group)
            ax = q.ndim - 2
            qx = lax.all_to_all(q, "model", split_axis=ax, concat_axis=ax)
            sx = lax.all_to_all(s, "model", split_axis=ax, concat_axis=ax)
            res[f"rs/{bits}"] = JQ.unpack_dequant(qx, sx, bits,
                                                  group).sum(axis=-2)
        return res

    f = jax.jit(jax.vmap(jax.vmap(per_rank, axis_name="model"),
                         axis_name="pod"))
    out = f.lower(data).compile(compiler_options=COMPILE)(data)
    return jax.tree.map(np.asarray, out)


def _pack_input(case):
    bits, group, rows, D = case
    rng = np.random.default_rng(bits + group + D)
    x = (rng.standard_normal((rows, D)) * 3.0).astype(np.float32)
    x[0, :3] = [0.5 * 127 / 3, 2.5, -3.5]          # near-ties
    return x


@functools.lru_cache(maxsize=None)
def _jax_pack_err():
    """The reference's pack followed by ``x - unpack_dequant`` for every
    case, f32 and from bf16, in one compiled function."""
    xs = [_pack_input(c) for c in PACK_CASES]

    def everything(xs):
        out = []
        for (bits, group, _, _), x in zip(PACK_CASES, xs):
            for xt in (x, x.astype(jnp.bfloat16)):
                q, s = JQ.quantize_pack(xt, bits, group)
                out.append((q, s.astype(jnp.float32),
                            xt.astype(jnp.float32)
                            - JQ.unpack_dequant(q, s, bits, group)))
        return out

    f = jax.jit(everything)
    return jax.tree.map(np.asarray,
                        f.lower(xs).compile(compiler_options=COMPILE)(xs))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("bits", BITS)
def test_slow_phase_plain_form_matches_jax(bits, layout):
    """The quantized recursive doubling's plain loop (the CPU path of
    ``hierarchical.quant_rd_all_reduce`` and of the kernel's wrapper)
    equals the reference's ``quant_rd_all_reduce`` over the pods bitwise,
    on whole tiles and on a message of 300 elements; every rank of a fast
    column holds the same sum."""
    pods, fast = layout
    mesh = VirtualMesh(pods, fast, device="cpu")
    for k in SLOW_SHAPES:
        t = torch.tensor(_rank_inputs(layout)[k])
        got = TH.quant_rd_all_reduce(t, TH.SLOW, bits, mesh.workspace)
        want = _jax_layout(layout)[f"slow/{bits}/{k}"]
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        assert all(torch.equal(got[0], got[p]) for p in range(1, pods))
        assert torch.equal(TR.quant_rd_all_reduce(t, TH.SLOW, bits), got)


@pytest.mark.parametrize("case", PACK_CASES,
                         ids=[f"b{c[0]}g{c[1]}" for c in PACK_CASES])
def test_pack_with_error_matches_jax(case):
    """``quantize_pack(..., err=True)`` gives the reference's payload and
    scales and ``x - unpack_dequant(q, s)`` bitwise, from f32 and bf16."""
    bits, group, _, _ = case
    i = PACK_CASES.index(case)
    x = torch.tensor(_pack_input(case))
    for xt, (qj, sj, ej) in zip((x, x.to(torch.bfloat16)),
                                _jax_pack_err()[2 * i:2 * i + 2]):
        q, s, e = TQ.quantize_pack(xt, bits, group, err=True)
        np.testing.assert_array_equal(q.numpy(), qj)
        np.testing.assert_array_equal(s.float().numpy(), sj)
        np.testing.assert_array_equal(e.numpy(), ej)
        assert e.dtype == torch.float32 and e.shape == x.shape
        q2, s2 = TQ.quantize_pack(xt, bits, group)
        assert torch.equal(q, q2) and torch.equal(s, s2)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("bits", BITS)
def test_strided_unpack_sum_matches_jax(bits, layout):
    """The reduce-scatter's receive as the port runs it, the unpack
    reading the all-to-all's transposed payload and scales and summing
    the pieces in index order, equals the reference's all-to-all, unpack
    and sum bitwise (two pieces: one rounding either way)."""
    pods, fast = layout
    v = torch.tensor(_rank_inputs(layout)["rs"])
    shard = v.shape[-1] // fast
    group = TQ.group_for(shard, bits)
    q, s = TQ.quantize_pack(v.reshape(*v.shape[:-1], fast, shard), bits,
                            group)
    piece = q.dim() - 2
    qv, sv = q.transpose(1, piece), s.transpose(1, piece)
    assert not qv.is_contiguous()
    got = TQ.unpack_dequant(qv, sv, bits, group, piece_dim=piece)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_layout(layout)[f"rs/{bits}"])
    np.testing.assert_array_equal(
        got.numpy(), TQ.unpack_dequant(qv, sv, bits, group).sum(-2).numpy())


def _storage(t):
    """t's whole storage as a flat tensor, and t's offset in it."""
    return (torch.empty(0, dtype=t.dtype).set_(t.untyped_storage()),
            t.storage_offset())


def _replay_geometry(packed, scales, out, bits, piece_dim):
    """What csrc/quant_pack.cu::unpack_dequant_kernel reads and writes,
    replayed in Python from the geometry the wrapper passes it."""
    group = out.shape[-1] // scales.shape[-1]
    g = TQ.unpack_geometry(packed, scales, out, bits, group, piece_dim)
    ndim, pieces, group, vec, D, pps, pss = g[:7]
    dims = [g[7 + 4 * d:11 + 4 * d] for d in range(ndim)]
    (pb, p0), (sb, s0), (ob, o0) = (_storage(packed), _storage(scales),
                                    _storage(out))
    rows = int(np.prod([d[0] for d in dims])) if dims else 1
    shift = group.bit_length() - 1
    for row in range(rows):
        po, so, oo, r = p0, s0, o0, row
        for size, ps, ss, os_ in reversed(dims):
            i, r = r % size, r // size
            po, so, oo = po + i * ps, so + i * ss, oo + i * os_
        j = torch.arange(D)
        acc = None
        for p in range(pieces):
            pay = pb[po + p * pps + (j if bits == 8 else j >> 1)] \
                .to(torch.int32)
            if bits == 4:
                nib = (pay & 0xFF) >> (4 * (j & 1)) & 0xF
                pay = torch.where(nib > 7, nib - 16, nib)
            d = pay.float() * sb[so + p * pss + (j >> shift)].float()
            acc = d if acc is None else acc + d
        ob[oo + j] = acc
    return g


@pytest.mark.parametrize("bits", BITS)
def test_unpack_geometry_addresses_the_views(bits):
    """The sizes and strides the wrapper hands the unpack kernel, collapsed
    (size-1 dims dropped, neighbours merged, contiguous rows joined into
    one), address exactly the views' elements: replayed in Python over
    the storages they give the same bits as the plain version, for the
    reduce-scatter's transposed pieces, the all-gather's broadcast written
    into the gathered layout, a contiguous payload and a column slice;
    the 16-byte path only where pointers and strides allow it."""
    rng = np.random.default_rng(bits)
    group = 64 if bits == 4 else 128
    v = torch.tensor(rng.standard_normal((4, 2, 3, 1, 2, 256)),
                     dtype=torch.float32)
    q, s = TQ.quantize_pack(v, bits, group)
    qv, sv = q.transpose(1, 4), s.transpose(1, 4)
    out = torch.zeros(4, 2, 3, 1, 256)
    g = _replay_geometry(qv, sv, out, bits, 4)
    assert g[0] == 3 and g[1] == 2        # (P, F, B) rows, 2 pieces
    assert torch.equal(out, TQ.unpack_dequant_sum_ref(qv, sv, bits, group,
                                                      4))
    # the all-gather: y (P, F, B, 1, D) packed, broadcast over its fast
    # group, written as the pieces of the gathered trailing dim
    q2, s2 = TQ.quantize_pack(v[:, :, :, :, 0], bits, group)
    qg = q2.unsqueeze(1).expand(4, 2, 2, 3, 1, q2.shape[-1])
    sg = s2.unsqueeze(1).expand(4, 2, 2, 3, 1, s2.shape[-1])
    full = torch.zeros(4, 2, 3, 1, 2, 256)
    g = _replay_geometry(qg, sg, full.movedim(4, 2), bits, None)
    assert g[3] == 1                      # aligned: the 16-byte path
    assert torch.equal(full.movedim(4, 2),
                       TQ.unpack_dequant_ref(qg, sg, bits, group))
    # contiguous: one row of every element
    res = torch.zeros(4, 2, 3, 1, 2, 256)
    g = _replay_geometry(q, s, res, bits, None)
    assert g[0] == 0 and g[4] == v.numel()
    assert torch.equal(res, TQ.unpack_dequant_ref(q, s, bits, group))
    # the second piece of every row: strided rows, a payload offset
    qc, sc = q[..., 1, :], s[..., 1, :]
    cut = torch.zeros(qc.shape[:-1] + (256,))
    _replay_geometry(qc, sc, cut, bits, None)
    assert torch.equal(cut, TQ.unpack_dequant_ref(qc, sc, bits, group))
    # an odd start: the scalar path
    base = torch.zeros(1 + q.numel(), dtype=torch.int8)[1:].view(q.shape)
    base.copy_(q)
    g = TQ.unpack_geometry(base, s, torch.empty(v.shape), bits, group, None)
    assert g[3] == 0


def test_ll_plan_of_the_slow_phase_kernel():
    """A 256-element tile sends 64 int8 or 32 int4 payload packets (4
    bytes each) and 1 or 2 scale packets (two bf16 scales each): exactly
    the reference's wire bytes, packets of 8 bytes beside them (LL doubles
    them), one receive row a step and rank.  One warp a tile and no more
    CTAs than the card holds resident."""
    for bits, group in ((8, 128), (4, 64)):
        for m in (8192, 4 * 2**20, 300, 1):
            tiles = -(-m // 256)
            assert TR.qrd_tiles(m) == tiles
            pk = TR.qrd_packets(m, bits)
            padded = 256 * tiles
            assert pk * 4 == padded * bits // 8 + 2 * padded // group
            assert TR.qrd_recv_bytes(2, 8, m, bits) == 2 * 8 * pk * 8
    assert TR.qrd_packets(8192, 8) == 32 * 65       # the decode message
    assert TR.qrd_packets(8192, 4) == 32 * 34
    # the prefill message's receive rows: about 136 MB on 4 x 2 ranks
    assert TR.qrd_recv_bytes(2, 8, 2**22, 8) == 2 * 8 * 16384 * 65 * 8
    assert TR.qrd_plan(32, 8, 1056) == 4              # decode: a tile a warp
    assert TR.qrd_plan(16384, 8, 1056) == 132         # prefill: capped
    assert TR.qrd_plan(1, 8, 1056) == 1
    for tiles, R, cap in ((32, 8, 1056), (16384, 8, 1056), (500, 16, 100)):
        assert TR.qrd_plan(tiles, R, cap) * R <= cap
    with pytest.raises(ValueError, match="resident"):
        TR.qrd_plan(64, 16, 8)


def test_wrappers_check_and_launch_nothing_on_the_cpu():
    """The new wrapper options and the quantized all-reduce that uses them
    run their plain versions on CPU tensors (no launch counted), and the
    wrappers refuse what the kernels do not take."""
    before = [w.launches for w in kernel_wrappers()]
    x = torch.randn(4, 2, 3, 1, 256)
    q, s, e = TQ.quantize_pack(x, 8, 128, err=True)
    TQ.unpack_dequant(q, s, 8, 128, piece_dim=3)
    TQ.unpack_dequant(q, s, 8, 128, out=torch.empty(x.shape))
    TR.quant_rd_all_reduce(x, 0, 4)
    mesh = VirtualMesh(4, 2, device="cpu")
    ctx = TCtx(tp_fast=("model",), tp_slow=("pod",), ar_strategy="hier_rd",
               ar_quant="int8")
    TH.tp_all_reduce(x.reshape(8, 3, 1, 256), ctx, mesh,
                     ef=torch.zeros(8, 3, 1, 256))
    assert [w.launches for w in kernel_wrappers()] == before
    with pytest.raises(ValueError, match="piece dim"):
        TQ.unpack_dequant(q, s, 8, 128, piece_dim=-1)
    with pytest.raises(ValueError, match="out must be"):
        TQ.unpack_dequant(q, s, 8, 128, out=torch.empty(3, 256))
    with pytest.raises(ValueError, match="power of two"):
        TR.quant_rd_all_reduce(torch.zeros(3, 2, 8), 0, 8)
    with pytest.raises(ValueError, match="axis"):
        TR.quant_rd_all_reduce(x, 2, 8)
    with pytest.raises(ValueError, match="bits"):
        TR.quant_rd_all_reduce(x, 0, 2)
