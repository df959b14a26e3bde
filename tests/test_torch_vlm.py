"""The VLM family (``pixtral-12b``; its smoke config here, 4 patches) in
the port, held against the JAX package on bridged f32 weights: the
configs field by field and ``param_count`` against every leaf; the
forward with precomputed patch embeddings overwriting the first
positions; prefill then teacher-forced decode steps against the full
forward and the JAX decode step; the overwrite itself (the tokens under
the patches do not matter) and a prompt shorter than the patches
refused; greedy ``generate(extra=)`` against the JAX engine's; paged ==
dense; tp=4 (2 x 2, hier_rd; GQA kv heads replicated over the ranks)
against tp=1 and the JAX TP path under nested ``jax.vmap``;
sequence-parallel prefill on == off at 2 x 2 and against the JAX SP
forward at one pod; the refusals; one serve CLI run.  The harness is
``test_torch_encdec.py``'s."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.inference.disagg import PrefillPool  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.inference.scheduler import ContinuousBatcher  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from test_torch_dense_archs import _leaves, _same_fields  # noqa: E402
from test_torch_encdec import (BLOCK, NEW, REL, S, S_MAX, TOL,  # noqa: E402
                               cfgs, extras, gathered, jax_run,
                               jax_tp_forward, margin_gate, port_run, relay,
                               sp_pair, tokens)
from test_torch_kvquant import jax_tree  # noqa: E402

torch.set_num_threads(1)

ARCH = "pixtral-12b"


@pytest.fixture(scope="module")
def pixtral():
    jcfg, tcfg = cfgs(ARCH)
    tree = jax_tree(jcfg)
    toks, extra = tokens(jcfg.vocab_size), extras(jcfg)
    want, dec = jax_run(jcfg, tree, toks, extra, S)
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, toks=toks, extra=extra,
                want=want, dec=dec, ap=TT.make_plan(tcfg, 1),
                model=params_from_numpy(tree, tcfg, "cpu"))


def test_configs_and_param_count():
    """The registered configs equal the reference's field by field;
    ``param_count`` is every leaf, the reference's count plus the norms it
    leaves out."""
    assert ARCH in ARCH_IDS
    _same_fields(get_config(ARCH), JR.get_config(ARCH))
    _same_fields(get_smoke(ARCH), JR.get_smoke(ARCH))
    cfg = get_smoke(ARCH)
    assert _leaves(cfg) == cfg.param_count()
    for ours, ref in ((cfg, JR.get_smoke(ARCH)),
                      (get_config(ARCH), JR.get_config(ARCH))):
        assert ours.param_count() == ref.param_count() \
            + (2 * ours.n_layers + 1) * ours.d_model
    assert get_config(ARCH).param_count() == 12_247_782_400


def test_forward_and_decode_match_jax(pixtral):
    """The forward's logits (the prompt's) and the teacher-forced decode
    path's against JAX (TOL); decode == the full forward (REL)."""
    p = pixtral
    full, dec, st = port_run(p["ap"], p["model"], p["toks"], p["extra"], S)
    np.testing.assert_allclose(full[:, :S], p["want"], atol=TOL, rtol=0)
    np.testing.assert_allclose(dec, p["dec"], atol=TOL, rtol=0)
    ref = full[:, S - 1:-1]
    rel = np.abs(dec[:, :-1] - ref[:, :dec.shape[1] - 1]).max() \
        / np.abs(ref).max()
    assert rel < REL, rel
    assert set(st) == {"k", "v"}


def test_patches_overwrite_the_first_positions(pixtral):
    """The tokens under the patches do not reach the logits (any ids there
    give the same logits bitwise), the patches do; a prompt shorter than
    the patches raises ValueError (the reference fails on a shape)."""
    p = pixtral
    n = p["tcfg"].n_patches
    toks = torch.as_tensor(p["toks"][:, :S]).long()
    ex = {k: torch.as_tensor(a) for k, a in p["extra"].items()}
    other = toks.clone()
    other[:, :n] = (other[:, :n] + 1) % p["tcfg"].vocab_size
    with torch.inference_mode():
        a, _ = TT.forward_lm(p["model"], toks, p["ap"], **ex)
        b, _ = TT.forward_lm(p["model"], other, p["ap"], **ex)
        c, _ = TT.forward_lm(p["model"], toks, p["ap"], patch_embeds=2
                             * ex["patch_embeds"])
        assert torch.equal(a, b) and not torch.allclose(a, c)
        with pytest.raises(ValueError, match="shorter than"):
            TT.forward_lm(p["model"], toks[:, :n - 1], p["ap"], **ex)


def test_generate_matches_jax_engine_and_paged_equals_dense(pixtral):
    """Greedy ``generate(extra=)`` against the JAX engine's, gated on the
    reference's top-1/top-2 gap; paged gives the dense tokens bitwise."""
    p = pixtral
    prompts = p["toks"][:, :S]
    ref = JaxEngine(JT.make_plan(p["jcfg"], 1), jax.tree.map(
        jnp.asarray, p["tree"]), s_max=S_MAX).generate(
        prompts, NEW, extra={k: jnp.asarray(a) for k, a in
                             p["extra"].items()})
    runs = {bs: InferenceEngine(p["ap"], p["model"], s_max=S_MAX,
                                block_size=bs, device="cpu").generate(
        prompts, NEW, extra=p["extra"]) for bs in (0, BLOCK)}
    full, _, _ = port_run(p["ap"], p["model"], ref.tokens, p["extra"], S)
    assert margin_gate(runs[0].tokens, ref.tokens, full, S) >= 2
    np.testing.assert_array_equal(runs[BLOCK].tokens, runs[0].tokens)


def test_tp4_matches_tp1_and_the_jax_tp_path(pixtral):
    """The tp=1 tree re-laid for tp=4 (kv heads replicated) on a 2 x 2 mesh
    (hier_rd): the forward and the decode path equal tp=1's within TOL,
    and the forward equals the JAX TP forward under nested vmap."""
    p = pixtral
    tree4 = relay(p["tree"], p["tcfg"], 4)
    mesh, ctx = mesh_and_ctx(4, 2, ar_strategy="hier_rd", device="cpu")
    ap4 = TT.make_plan(p["tcfg"], 4)
    model4 = params_from_numpy(tree4, p["tcfg"], "cpu", mesh=mesh)
    full, dec, _ = port_run(ap4, model4, p["toks"], p["extra"], S, ctx=ctx,
                            mesh=mesh)
    v = p["tcfg"].vocab_size
    np.testing.assert_allclose(full[:, :S, :v], p["want"], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(dec[..., :v], p["dec"], atol=TOL, rtol=0)
    jtp = gathered(jax_tp_forward(p["jcfg"], tree4, ctx, 2, 2, p["toks"],
                                  p["extra"]))
    np.testing.assert_allclose(full, jtp, atol=TOL, rtol=0)


def test_sequence_parallel_on_equals_off(pixtral):
    """SP on (the overwritten sequence cut to each rank's fast piece) ==
    SP off at 2 x 2 within TOL, and at one pod (1 x 4) equal to the JAX
    SP forward (at 2 x 2 the reference's forward does not trace; ROADMAP
    §3)."""
    p = pixtral
    tree4 = relay(p["tree"], p["tcfg"], 4)
    for pods in (2, 1):
        mesh, ctx = mesh_and_ctx(4, pods, ar_strategy="hier_rd",
                                 device="cpu")
        model = params_from_numpy(tree4, p["tcfg"], "cpu", mesh=mesh)
        ap = TT.make_plan(p["tcfg"], 4)
        (on, _), (off, _), n = sp_pair(model, ap, ctx, mesh,
                                       p["toks"][:, :S], p["extra"])
        assert n == 2 * p["tcfg"].n_layers
        np.testing.assert_allclose(on.numpy(), off.numpy(), atol=TOL, rtol=0)
        if pods == 1:
            jsp = jax_tp_forward(p["jcfg"], tree4, ctx, 1, 4,
                                 p["toks"][:, :S], p["extra"], sp=True)
            np.testing.assert_allclose(on.numpy(), jsp, atol=TOL, rtol=0)


def test_refusals(pixtral):
    """The batcher (its requests carry no patches), trace mode (the
    reference's words), speculative decoding and the disaggregated
    prefill pool refuse the family; a patch tensor of another shape and
    frames are refused by ``generate``."""
    p = pixtral
    ap, model = p["ap"], p["model"]
    with pytest.raises(ValueError, match="text-only"):
        ContinuousBatcher(ap, model, slots=2, s_max=S_MAX, device="cpu")
    with pytest.raises(SystemExit, match="trace mode supports text-only"):
        serve.main(["--arch", ARCH, "--mode", "trace", "--device", "cpu"])
    with pytest.raises(ValueError, match="dense families"):
        InferenceEngine(ap, model, s_max=S_MAX, spec_mode="ngram",
                        device="cpu")
    with pytest.raises(ValueError, match="dense families"):
        PrefillPool(ap, model, s_max=S_MAX, device="cpu")
    eng = InferenceEngine(ap, model, s_max=S_MAX, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        eng.generate(p["toks"][:, :S], NEW, extra={
            "patch_embeds": p["extra"]["patch_embeds"][:, :2]})
    with pytest.raises(ValueError, match="frame_embeds"):
        eng.generate(p["toks"][:, :S], NEW, extra={
            "frame_embeds": p["extra"]["patch_embeds"]})


def test_serve_cli_batch_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--mode", "batch", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--max-new", "4",
                      "--tp", "4", "--pods", "2", "--ar-strategy",
                      "hier_rd"])
    assert res.new_tokens.shape == (2, 4)
    assert "(4 patches) tp=4 (2x2)" in capsys.readouterr().out
