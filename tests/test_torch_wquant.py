"""The port's int8 block weights (``weight_quant``) held against the JAX
package: ``quantize_params`` bitwise the reference's (eager JAX), the
quantized tree carried across the bridge and cut over the mesh equal to
``quantize_model`` of the cut model, the plain ``w8_matmul`` against
``rank_matmul`` on the dequantized weight, and the decode logits against
the reference's ``decode_step(layer_map=dequant_layer)`` at tp=1 and at
tp=4 through the virtual mesh.  Smoke sizes, f32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.parallel import quant as JQ  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.parallel import quant as TQ  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.kernels.w8_matmul import w8_matmul  # noqa: E402
from test_torch_kvquant import (S, NEW, TINY, inputs, jax_tree,  # noqa: E402
                                port_model, run_jax, run_port, tiny_cfgs)

torch.set_num_threads(1)

# f32 decode logits under int8 weights: both sides multiply the same
# bf16-valued weights (dequant_layer's) in f32, in another summation
# order: ~1e-6 on O(1) logits.  The quantization itself moves them by
# ~1e-2, so a wrong scale axis or rounding shows.
WQ_TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = tiny_cfgs()
    return dict(jcfg=jcfg, tcfg=tcfg, tree=jax_tree(jcfg))


def _global_tree(tree, n_layers):
    """The numpy tree as the port's global tree of per-layer groups."""
    blocks = [{g: ({k: torch.tensor(np.asarray(a)[i]) for k, a in grp.items()}
                   if isinstance(grp, dict)
                   else torch.tensor(np.asarray(grp)[i]))
               for g, grp in tree["blocks"].items()} for i in range(n_layers)]
    return {"embed": {k: torch.tensor(a) for k, a in tree["embed"].items()},
            "blocks": blocks, "final_norm": {
                k: torch.tensor(a) for k, a in tree["final_norm"].items()}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_is_bitwise_the_reference(tiny, dtype):
    """q and s of every block leaf equal the reference's eager
    ``quantize_params``; the skipped leaves (norms) stay as they were."""
    cast = (lambda a: a) if dtype == "float32" else (
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)))
    tree = jax.tree.map(cast, tiny["tree"])
    want = JQ.quantize_params(jax.tree.map(jnp.asarray, tree))
    ours = _global_tree(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     tree), 2)
    if dtype == "bfloat16":
        ours = jax.tree.map(lambda t: t.bfloat16(), ours)
    got = TQ.quantize_params(ours)
    n = 0
    for i, layer in enumerate(got["blocks"]):
        for g, grp in layer.items():
            for k, leaf in grp.items():
                ref = want["blocks"][g][k]
                if TQ.is_qs(leaf):
                    np.testing.assert_array_equal(
                        leaf["q"].numpy(), np.asarray(ref["q"])[i])
                    np.testing.assert_array_equal(
                        leaf["s"].float().numpy(),
                        np.asarray(ref["s"], np.float32)[i])
                    n += 1
                else:
                    assert not isinstance(ref, dict), (g, k)
    assert n == 2 * 7          # wq, wk, wv, wo, wg, wu, wd a layer


def test_bridged_quantized_tree_equals_quantize_model_at_tp4(tiny):
    """The reference's quantized tree carried across the bridge and cut
    over a 2 x 2 mesh equals ``quantize_model`` of the cut bf16 model bit
    for bit: the scale the global reduction takes over a cut dim is the
    max over the ranks; a column-cut leaf's scale is cut with it."""
    tree = tiny["tree"]
    qtree = jax.tree.map(np.asarray, JQ.quantize_params(
        jax.tree.map(jnp.asarray, tree)))
    mesh, _ = mesh_and_ctx(4, 2, ar_strategy="hier_rd", device="cpu")
    bridged = params_from_numpy(qtree, tiny["tcfg"], "cpu", mesh=mesh)
    ours = TQ.quantize_model(params_from_numpy(tree, tiny["tcfg"], "cpu",
                                               mesh=mesh))
    for a, b in zip(bridged.blocks, ours.blocks):
        for g in ("attn", "mlp"):
            for k, leaf in getattr(a, g).items():
                mine = getattr(b, g)[k]
                assert torch.equal(leaf["q"], mine["q"]), (g, k)
                assert torch.equal(leaf["s"], mine["s"]), (g, k)
    assert bridged.blocks[0].mlp["wg"]["s"].shape == (4, 1, 32)
    assert bridged.blocks[0].attn["wq"]["s"].shape == (4, 1, 1, 16)


@pytest.mark.parametrize("P", [16, 96])
def test_plain_w8_matmul_is_rank_matmul_on_the_dequantized_weight(P):
    """The plain version of the W8 GEMM equals ``rank_matmul`` on
    ``dequant_layer``'s weight, the column's scale s[n % P] (P = hd for the
    qkv leaves)."""
    rng = np.random.default_rng(P)
    x = torch.tensor(rng.standard_normal((2, 5, 48)), dtype=torch.float32)
    q = torch.tensor(rng.integers(-127, 128, (2, 48, 96)), dtype=torch.int8)
    s = torch.tensor(rng.random((2, P)) / 50).bfloat16()
    w = (q.float() * s.float().repeat(1, 96 // P)[:, None]).bfloat16()
    assert torch.equal(w8_matmul(x, q, s), TL.rank_matmul(x, w.float()))
    qs = {"q": q.reshape(2, 48, 96 // P, P), "s": s.reshape(2, 1, 1, P)}
    assert torch.equal(TL.rank_matmul(x, TL.flat_weight(qs, 48)),
                       torch.bmm(x, TQ.dequant(qs).reshape(2, 48, 96).float()))


def test_weight_quant_logits_match_jax_at_tp1_and_tp4(tiny):
    """Prefill on the bf16 weights, then teacher-forced decode with the
    quantized model through the LayerMap: logits within WQ_TOL of the JAX
    decode step under ``layer_map=dequant_layer``, at tp=1 and on a 2 x 2
    mesh (hier_rd), and with the overlapped projections, where ``wo`` and
    ``wd`` are dequantized a layer at a time."""
    prompts, forced = inputs(TINY["vocab_size"], seed=4)
    s_max = S + NEW + 1
    want, _ = run_jax(tiny["jcfg"], tiny["tree"], prompts, forced, s_max,
                      weight_quant=True)
    plain, _ = run_jax(tiny["jcfg"], tiny["tree"], prompts, forced, s_max)
    assert np.abs(plain[:, 1:] - want[:, 1:]).max() > 100 * WQ_TOL
    v = TINY["vocab_size"]
    for tp, pods, strategy in ((1, 1, "hier_rd"), (4, 2, "hier_rd")):
        run = port_model(tiny["tcfg"], tiny["tree"], tp, pods, strategy)
        got, _ = run_port(*run, prompts, forced, s_max, weight_quant=True)
        np.testing.assert_allclose(got[..., :v], want, atol=WQ_TOL, rtol=0)
    ap, model, ctx, mesh = port_model(tiny["tcfg"], tiny["tree"], 4, 2)
    got, _ = run_port(ap, model, ctx.replace(overlap_matmul=True), mesh,
                      prompts, forced, s_max, weight_quant=True)
    np.testing.assert_allclose(got[..., :v], want, atol=WQ_TOL, rtol=0)
