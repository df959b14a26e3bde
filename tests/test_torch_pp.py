"""The port's pipeline-parallel forward (the paper's HP scheme, GPipe PP x
TP: ``repro_torch/parallel/pp.py``) held against the JAX package.

The reference's own ``build_pp_forward`` needs 8 host devices and no JAX
test runs its case (``tests/dist_cases/case_pp_and_perf.py``); that case's
bar is the JAX ``forward_lm`` on ``LOCAL``, and so is this file's: the
JAX ``init_params`` tree at tp=1, re-laid for the plan at the fast size
(``test_torch_encdec.relay``: heads moved into their slots, the vocab
zero-padded), bridged over the fast axis and re-laid into the stage
layout (``pp.to_stages``), gives logits within 1e-5
(relative to the largest) of the JAX local forward over the real vocab,
on every stage.  The case's tiny dense config at four (stages, fast,
microbatches) layouts, the MoE, RWKV6 and hybrid smoke models at (2, 2,
2), kernel 3's calls a forward, and the refusals."""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.pcontext import LOCAL as JLOCAL  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.mesh import VirtualMesh  # noqa: E402
from repro_torch.core.pcontext import ParallelCtx  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.parallel import pp  # noqa: E402
from test_torch_encdec import relay  # noqa: E402
from test_torch_kvquant import FAST_COMPILE, jax_tree  # noqa: E402

torch.set_num_threads(1)

# f32 logits: the same math with the TP sums taken over the fast ranks,
# ~1e-7 of the largest logit.
REL = 1e-5
# The reference case's tiny dense config (case_pp_and_perf.py:10-12).
TINY = dict(family="dense", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=96)
PP_CTX = ParallelCtx(tp_fast=("model",), ep=("model",))
# Capacity large enough that no microbatch drops a (token, k) pair (the
# capacity is reckoned per dispatch), as case_train_parity.py raises it.
NO_DROP = 8.0


def _jax_logits(jcfg, tree, tokens):
    jap = JT.make_plan(jcfg, 1)
    fwd = jax.jit(lambda p, t: JT.forward_lm(p, t, jap, JLOCAL)[0]).lower(
        tree, tokens).compile(compiler_options=FAST_COMPILE)
    return np.asarray(fwd(tree, tokens))


def _pp_logits(tcfg, tree, tokens, stages, fast, microbatches, ctx=PP_CTX):
    """The port's PP logits over the real vocab, (stages, B, S, V): each
    stage's fast shards gathered."""
    mesh = VirtualMesh(stages, fast, device="cpu")
    ap = TT.make_plan(tcfg, fast)
    model = pp.to_stages(params_from_numpy(
        relay(tree, tcfg, fast), tcfg, "cpu",
        mesh=VirtualMesh(1, fast, device="cpu")), mesh)
    fn = pp.build_pp_forward(ap, ctx, mesh, stage_axis="pod",
                          microbatches=microbatches)
    with torch.inference_mode():
        lg = fn(model, torch.as_tensor(tokens).long())
    lg = lg.reshape(stages, fast, *lg.shape[1:]).movedim(1, -2)
    return lg.flatten(-2)[..., :tcfg.vocab_size].numpy()


def _check(got, want):
    for s in range(got.shape[0]):
        err = np.abs(got[s] - want).max() / np.abs(want).max()
        assert err < REL, (s, err)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JC.ModelConfig(name="t", dtype=jnp.float32, **TINY)
    tcfg = TC.ModelConfig(name="t", dtype=torch.float32, **TINY)
    tree = jax_tree(jcfg)
    tokens = np.random.default_rng(1).integers(0, 96, (8, 16)) \
        .astype(np.int32)
    return tcfg, tree, tokens, _jax_logits(jcfg, tree, tokens)


@pytest.mark.parametrize("stages,fast,microbatches",
                         [(2, 4, 4), (4, 2, 4), (2, 1, 1), (4, 1, 2)])
def test_pp_logits_match_jax_local(tiny, stages, fast, microbatches):
    tcfg, tree, tokens, want = tiny
    _check(_pp_logits(tcfg, tree, tokens, stages, fast, microbatches), want)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "rwkv6-7b",
                                  "hymba-1.5b"])
def test_pp_families_match_jax_local(arch):
    """The MoE, RWKV6 and hybrid smoke models (2 layers, vocab 97, padded
    at tp 2) in f32 at 2 stages x 2 ranks, 2 microbatches."""
    kw = {"dtype": jnp.float32}
    if arch == "qwen3-moe-30b-a3b":
        kw["capacity_factor"] = NO_DROP
    jcfg = dataclasses.replace(jax_smoke(arch), **kw)
    tcfg = dataclasses.replace(get_smoke(arch), **{**kw,
                                                   "dtype": torch.float32})
    tree = jax_tree(jcfg)
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (4, 8)).astype(np.int32)
    _check(_pp_logits(tcfg, tree, tokens, 2, 2, 2),
           _jax_logits(jcfg, tree, tokens))


def test_kernel3_calls_a_forward(tiny):
    """One kernel-3 call a block call: (L / P) x (M + P - 1) = 2 x 5 a
    forward at 2 stages and 4 microbatches, the L / P blocks of every
    stage in one call."""
    tcfg, tree, tokens, _ = tiny
    calls = mock.patch.object(TL, "flash_attention",
                              wraps=TL.flash_attention)
    with calls as spy:
        _pp_logits(tcfg, tree, tokens, 2, 2, 4)
    assert spy.call_count == (4 // 2) * (4 + 2 - 1)


@pytest.mark.parametrize("case", ["layers", "batch", "encdec", "vlm"])
def test_refusals(tiny, case):
    """Layers the stages do not divide, a batch the microbatches do not
    divide, and the frame- and patch-fed families (the reference's
    ``build_pp_forward`` takes tokens only)."""
    tcfg, tree, tokens, _ = tiny
    mesh = VirtualMesh(2, 2, device="cpu")
    if case == "layers":
        cfg = dataclasses.replace(tcfg, n_layers=3)
        with pytest.raises(ValueError, match="not divisible by 2 pipeline"):
            pp.build_pp_forward(TT.make_plan(cfg, 2), PP_CTX, mesh,
                             stage_axis="pod", microbatches=1)
    elif case == "batch":
        with pytest.raises(ValueError, match="batch 8 is not divisible"):
            _pp_logits(tcfg, tree, tokens, 2, 2, 3)
    else:
        arch = {"encdec": "whisper-medium", "vlm": "pixtral-12b"}[case]
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        with pytest.raises(ValueError, match="takes tokens only"):
            pp.build_pp_forward(TT.make_plan(cfg, 2), PP_CTX, mesh,
                             stage_axis="pod", microbatches=1)


def test_stage_layout_of_a_cut_model_and_the_mesh_checks(tiny):
    """``to_stages`` of the model cut over the fast axis: rank (s, f)'s
    block j is global layer s * L / P + j's cut f, the embedding and final
    norm the same on every stage, and a model not cut over the fast axis
    is refused; the stage axis must be the slow axis and no TP axis, and
    other callers of the mesh still refuse a non-TP axis of size > 1."""
    tcfg, tree, _, _ = tiny
    mesh = VirtualMesh(2, 2, device="cpu")
    ap = TT.make_plan(tcfg, 2)
    cut = params_from_numpy(relay(tree, tcfg, 2), tcfg, "cpu",
                            mesh=VirtualMesh(1, 2, device="cpu"))
    staged = pp.to_stages(cut, mesh)
    assert len(staged.blocks) == 2 and staged.n_ranks == 4
    per = dict(cut.named_parameters())
    for k, v in staged.named_parameters():
        name = k.split(".")
        v = v.reshape(2, 2, *v.shape[1:])
        for s in range(2):
            if name[0] == "blocks":
                name[1] = str(s * 2 + int(k.split(".")[1]))
            torch.testing.assert_close(v[s], per[".".join(name)], rtol=0,
                                       atol=0)
    with pytest.raises(ValueError, match="not cut over the fast axis"):
        pp.to_stages(staged, mesh)
    with pytest.raises(ValueError, match="stage axis 'model'"):
        pp.build_pp_forward(ap, PP_CTX, mesh, stage_axis="model",
                         microbatches=1)
    with pytest.raises(ValueError, match="stage axis 'pod'"):
        pp.build_pp_forward(ap, PP_CTX.replace(tp_slow=("pod",)), mesh,
                         stage_axis="pod", microbatches=1)
    with pytest.raises(ValueError, match="is not a TP axis"):
        TT.check_layout(ap, PP_CTX, mesh)
    with pytest.raises(ValueError, match="full-precision wire"):
        pp.build_pp_forward(ap, PP_CTX.replace(overlap_matmul=True), mesh,
                         stage_axis="pod", microbatches=1)
