"""The port's overlapped collective matmul (``repro_torch/core/overlap.py``)
and the plain version of its fused GEMM + recursive-doubling kernel held
against the JAX package's ``core/overlap.py`` under nested ``jax.vmap``
(the rank-batched picture of its ``shard_map`` code), and the
``auto + overlap`` path end to end against ``flat`` and the JAX local
engine (the port's version of the e2e part of
``tests/dist_cases/case_overlap_autotune.py``).

The JAX side of every comparison is traced once per mesh layout, in one
jitted function compiled without XLA's backend optimisations, and cached:
one-op-at-a-time dispatch of the same grid, or an optimised compile,
takes several times as long on one core."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import autotune as JA  # noqa: E402
from repro.core import comm_model as JCM  # noqa: E402
from repro.core import hierarchical as JH  # noqa: E402
from repro.core import overlap as JO  # noqa: E402
from repro.core.pcontext import ParallelCtx as JCtx  # noqa: E402
from repro.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.core import autotune as TA  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.core import overlap as TO  # noqa: E402
from repro_torch.core.mesh import VirtualMesh  # noqa: E402
from repro_torch.core.pcontext import ParallelCtx as TCtx  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.kernels import fused_matmul_rd as fmrd  # noqa: E402
from repro_torch.kernels import kernel_wrappers  # noqa: E402
from repro_torch.kernels.rd_allreduce import RDWorkspace  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from test_torch_tp import _cfgs, _prompts  # noqa: E402

torch.set_num_threads(1)

STRATEGIES = ("flat", "hier_ring", "hier_rd", "hier_rd_halving", "auto")
LAYOUTS = ((2, 1), (2, 2), (4, 2))
CHUNKS = (1, 2, 4)
# per-rank x and w of each projection: MLP down "bsf,fd->bsd" and
# attention wo "bsqh,qhd->bsd"; d = 32 splits into 4 chunks of 8
SPECS = {"mlp": ("bsf,fd->bsd", (2, 4, 16), (16, 32)),
         "attn": ("bsqh,qhd->bsd", (2, 4, 4, 8), (4, 8, 32))}
RS_STRATEGIES = ("flat", "hier_rd", "auto")
# f32, O(1) outputs: the same products and sums in another order
ATOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _wiring(strategy):
    return dict(tp_fast=("model",), tp_slow=("pod",), ar_strategy=strategy)


def _data(layout, spec):
    """(x, w) of every rank, (pods, fast, *local): w ~ N(0, 1/K) so every
    partial sum is O(1)."""
    _, xs, ws = SPECS[spec]
    rng = np.random.default_rng(10 * sum(layout) + list(SPECS).index(spec))
    x = rng.standard_normal(layout + xs).astype(np.float32)
    k = int(np.prod(ws[:-1]))
    w = (rng.standard_normal(layout + ws) / np.sqrt(k)).astype(np.float32)
    return x, w


@functools.lru_cache(maxsize=None)
def _jax_results(layout):
    """Every JAX output the tests compare with, for one (pods, fast)
    layout: ``collective_matmul`` per spec, strategy and chunk count, the
    function ``collective_matmul_pallas`` computes (``psum`` over fast of
    ``rd_all_reduce`` over the pods of the einsum), and
    ``collective_matmul_reduce_scatter``; "auto" resolves against the
    PERLMUTTER network, the port's default."""
    data = {s: _data(layout, s) for s in SPECS}

    def everything(d):
        out = {}
        for name, (spec, _, _) in SPECS.items():
            def per_rank(x, w, spec=spec, name=name):
                res = {}
                for s in STRATEGIES:
                    ctx = JCtx(**_wiring(s))
                    for c in CHUNKS:
                        res[f"cm/{s}/{c}"] = JO.collective_matmul(
                            x, w, ctx, spec=spec, chunks=c)
                    if name == "mlp" and s in RS_STRATEGIES:
                        for c in (1, 4):
                            res[f"rs/{s}/{c}"] = \
                                JO.collective_matmul_reduce_scatter(
                                    x, w, ctx, dim=1, spec=spec, chunks=c)
                res["fused"] = jax.lax.psum(JH.rd_all_reduce(
                    jnp.einsum(spec, x, w), "pod"), "model")
                return res
            out[name] = jax.vmap(jax.vmap(per_rank, axis_name="model"),
                                 axis_name="pod")(*d[name])
        return out

    with JA.using(JA.AutoTuner(JCM.PERLMUTTER)):
        res = jax.jit(everything).lower(data).compile(
            compiler_options=FAST_COMPILE)(data)
    return jax.tree.map(np.asarray, res)


def _port(layout, spec):
    pods, fast = layout
    x, w = _data(layout, spec)
    R = pods * fast
    return (torch.tensor(x.reshape(R, *x.shape[2:])),
            torch.tensor(w.reshape(R, *w.shape[2:])),
            VirtualMesh(pods, fast, device="cpu"))


def _want(layout, spec, key):
    v = _jax_results(layout)[spec][key]
    return v.reshape(layout[0] * layout[1], *v.shape[2:])


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("backend", ["fused", "lax"])
def test_collective_matmul_matches_jax(backend, strategy, layout, spec):
    """Both forms, every chunk count, against the reference's (lax form)
    ``collective_matmul``; the fused form reaches the kernel's plain
    version under hier_rd (and under auto, which picks hier_rd here)."""
    x, w, mesh = _port(layout, spec)
    ctx = TCtx(**_wiring(strategy))
    before = fmrd.collective_matmul_rd.launches
    for c in CHUNKS:
        with TA.using(TA.AutoTuner()):
            got = TO.collective_matmul(x, w, ctx, mesh, chunks=c,
                                       backend=backend)
        want = _want(layout, spec, f"cm/{strategy}/{c}")
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    assert fmrd.collective_matmul_rd.launches == before   # CPU: no launch


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
def test_fused_plain_version_matches_jax_composition(layout, spec):
    """The kernel's plain version, plus the fast sum the caller adds, is
    the function ``collective_matmul_pallas`` computes, and its output
    does not depend on the column blocks (bitwise)."""
    x, w, mesh = _port(layout, spec)
    pods, fast = layout
    want = _want(layout, spec, "fused")
    R, kd = x.shape[0], int(np.prod(w.shape[1:-1]))
    y = fmrd.collective_matmul_rd_ref(x.reshape(R, -1, kd),
                                      w.reshape(R, kd, -1), pods)
    got = y.reshape(pods, fast, *y.shape[1:]).sum(1, keepdim=True)
    got = got.expand(pods, fast, *y.shape[1:]).reshape(want.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    ctx = TCtx(**_wiring("hier_rd"))
    outs = [TO.collective_matmul(x, w, ctx, mesh, chunks=c)
            for c in (1, 2, 4, 8)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0], got.reshape(outs[0].shape))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("strategy", RS_STRATEGIES)
def test_collective_matmul_reduce_scatter_matches_jax(strategy, layout):
    x, w, mesh = _port(layout, "mlp")
    ctx = TCtx(**_wiring(strategy))
    for c in (1, 4):
        with TA.using(TA.AutoTuner()):
            got = TO.collective_matmul_reduce_scatter(x, w, ctx, mesh, dim=1,
                                                      chunks=c)
        want = _want(layout, "mlp", f"rs/{strategy}/{c}")
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def test_chunks_resolution_and_auto_dispatch():
    """``_resolve_chunks`` is the reference's, and ``auto`` is resolved
    once from the unchunked output: one lookup per call, on the bucket of
    the whole (b, s, d) message."""
    for d, fast, req in ((32, 2, 4), (2048, 2, 4), (30, 4, 8), (7, 1, 4),
                         (8, 8, 3)):
        assert TO._resolve_chunks(d, fast, req) == \
            JO._resolve_chunks(d, fast, req)
    x, w, mesh = _port((4, 2), "attn")
    tuner = TA.AutoTuner()
    with TA.using(tuner):
        TO.collective_matmul(x, w, TCtx(**_wiring("auto")), mesh, chunks=4)
    assert tuner.lookups == {f"b{TA.bucket_of(2 * 4 * 32 * 4)}/f2/s4/"
                             "float32": 1}
    with pytest.raises(ValueError, match="backend"):
        TO.collective_matmul(x, w, TCtx(**_wiring("flat")), mesh,
                             backend="pallas")
    local = TO.collective_matmul(x, w, TCtx(), None)
    assert torch.equal(local, TO.project(x, w))


def test_kernel_wrapper_on_cpu_launches_nothing():
    """A CPU tensor takes the plain version and counts no launch; shapes
    the kernel does not take raise on every device."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((8, 3, 16)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((8, 16, 24)), dtype=torch.float32)
    before = [k.launches for k in kernel_wrappers()]
    got = fmrd.collective_matmul_rd(x, w, 4, n_chunks=3,
                                    workspace=RDWorkspace())
    assert [k.launches for k in kernel_wrappers()] == before
    assert torch.equal(got, fmrd.collective_matmul_rd_ref(x, w, 4))
    assert torch.equal(fmrd.collective_matmul_rd(x, w, 1),
                       torch.bmm(x, w))                 # one pod: the GEMM
    with pytest.raises(ValueError, match="power-of-two"):
        fmrd.collective_matmul_rd(x, w, 3)
    with pytest.raises(ValueError, match="are not"):
        fmrd.collective_matmul_rd(x, w[:4], 4)
    with pytest.raises(ValueError, match="divide N"):
        fmrd.collective_matmul_rd(x, w, 4, n_chunks=5)


# (M, N, n_chunks, bf16) -> (tile, tiles a rank): llama3.2-1b's decode
# (wo and MLP down, 8 rows) and prefill (4096 rows; 4600 in the teacher-
# forced prefill) at tp=8 over N = d_model 2048, and ragged row counts.
FUSED_PLANS = [
    (8, 2048, 1, True, (8, 64), 32),       # decode: rows on the n8 side
    (8, 2048, 8, True, (8, 64), 32),
    (12, 2048, 4, True, (16, 64), 32),     # two n8 blocks
    (16, 2048, 2, True, (16, 64), 32),
    (17, 2048, 2, True, (128, 128), 16),
    (4096, 2048, 1, True, (128, 128), 512),
    (4096, 2048, 8, True, (128, 128), 512),
    (4600, 2048, 4, True, (128, 128), 36 * 16),
    (100, 200, 1, True, (128, 128), 2),    # a partial column tile
    (100, 200, 5, True, (128, 128), 5),
    (8, 2048, 4, False, (16, 64), 32),     # f32: its CUDA-core configs
    (4096, 2048, 2, False, (64, 64), 64 * 32),
]


@pytest.mark.parametrize("M,N,chunks,bf16,tile,tiles", FUSED_PLANS)
def test_fused_kernel_tile_plan(M, N, chunks, bf16, tile, tiles):
    """The kernel's tile config depends on M and the type only (so an
    element's sum order never depends on ``n_chunks``), and the flags a
    step needs follow its tile count."""
    assert fmrd.tile_shape(M, bf16) == tile
    assert fmrd.tiles_per_rank(M, N, chunks, bf16) == tiles


def test_fused_kernel_chunks_cut_whole_tiles_on_the_path():
    """At the path's N (d_model 2048) every chunk count the tuner may pick
    cuts whole tiles, so each tile's columns start at the same offsets
    whatever ``n_chunks``, and the tile count does not move."""
    for M in (8, 4096):
        for bf16 in (True, False):
            bn = fmrd.tile_shape(M, bf16)[1]
            counts = {fmrd.tiles_per_rank(M, 2048, k, bf16)
                      for k in (1, 2, 4, 8)}
            assert all((2048 // k) % bn == 0 for k in (1, 2, 4, 8))
            assert len(counts) == 1


def test_fused_kernel_vector_path_conditions():
    """The bf16 (tensor-core) kernel takes whole 16-byte vectors only: K
    and N / n_chunks multiples of 8 bf16 (4 f32) and aligned pointers;
    the wrapper refuses a CUDA call without them."""
    x = torch.zeros((2, 8, 1024), dtype=torch.bfloat16)
    assert fmrd.vector_ok((x,), 1024, 256)
    assert not fmrd.vector_ok((x,), 1020, 256)
    assert not fmrd.vector_ok((x,), 1024, 252)
    assert fmrd.vector_ok((x.float(),), 1020, 252)
    off = torch.zeros(2 * 8 * 1024 + 1, dtype=torch.bfloat16)[1:]
    assert not fmrd.vector_ok((off,), 1024, 256)


def _tiny_tree(jap):
    """Seeded numpy parameters in the JAX layout of ``jap`` (norms 1,
    every other leaf N(0, 1/64)): drawn with numpy, not by the JAX
    ``init_params``, whose compile dominates a one-core run."""
    shapes = jax.eval_shape(lambda k: JT.init_params(k, jap),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        if any(getattr(p, "key", None) in ("ln1", "ln2", "final_norm")
               for p in path):
            return np.ones(s.shape, np.float32)
        return (rng.standard_normal(s.shape) / 8).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_auto_overlap_tokens_match_flat_and_jax_local(monkeypatch):
    """tiny tp=8 (4 pods x 2, f32, 8 q and 8 kv heads, so the tp=8 plan
    has no dead slot and one tree serves tp=8 and tp=1): ``auto +
    overlap`` greedy tokens equal ``flat``'s and the JAX local engine's,
    with every projection through the fused kernel's form (auto picks
    hier_rd at these sizes)."""
    jcfg, tcfg = _cfgs(n_heads=8, n_kv_heads=8, head_dim=8)
    jap1 = JT.make_plan(jcfg, 1)
    tree = _tiny_tree(jap1)
    prompts = _prompts(tcfg.vocab_size, seed=5)
    s_max = prompts.shape[1] + 4
    ref = JaxEngine(jap1, jax.tree.map(jnp.asarray, tree),
                    s_max=s_max).generate(prompts, 4)
    mesh, ctx = mesh_and_ctx(8, 4, ar_strategy="flat", device="cpu")
    tap = TT.make_plan(tcfg, 8)
    assert tap.q_mask_tbl is None
    model = params_from_numpy(tree, tcfg, "cpu", mesh=mesh)
    fused = []
    real = TO._fused_rd
    monkeypatch.setattr(TO, "_fused_rd",
                        lambda *a: fused.append(1) or real(*a))
    toks = {}
    for name, c in (("flat", ctx), ("auto+overlap", ctx.replace(
            ar_strategy="auto", overlap_matmul=True))):
        toks[name] = InferenceEngine(
            tap, model, ctx=c, mesh=mesh, s_max=s_max,
            ar_table=TA.AutoTuner(), device="cpu").generate(prompts, 4).tokens
    np.testing.assert_array_equal(toks["auto+overlap"], toks["flat"])
    np.testing.assert_array_equal(toks["auto+overlap"], ref.tokens)
    assert len(fused) == 2 * tcfg.n_layers * 4      # prefill + 3 steps


def test_serve_cli_auto_overlap_on_cpu(capsys, tmp_path):
    table = tmp_path / "table.json"
    TA.AutoTuner().save(str(table))
    res = serve.main(["--arch", "llama3.2-1b", "--mode", "batch",
                      "--device", "cpu", "--tp", "8", "--pods", "4",
                      "--ar-strategy", "auto", "--overlap",
                      "--overlap-chunks", "2", "--ar-table", str(table),
                      "--batch", "2", "--prompt-len", "8", "--max-new", "3"])
    assert res.new_tokens.shape == (2, 3)
    assert "tp=8 (4x2) ar=auto overlap(2)" in capsys.readouterr().out
