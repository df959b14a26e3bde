"""The other dense archs of the reference's registry and the paper's own
models in the port: ``mistral-large-123b``, the QKV-bias Qwen1.5 archs
(``codeqwen1.5-7b``, ``qwen1.5-32b``) and ``configs/llama3_paper.py``'s
Llama 3.1 70B / 405B against the reference's configs field by field;
``param_count`` against every leaf of the seeded init; and the QKV-bias
smoke models, with nonzero biases planted (the reference draws them as
zeros, where a missing or misplaced add computes the same numbers), against
the JAX forward and decode steps at tp=1 and on a 2 x 2 mesh, through the
bridge, the sharding rules and the int8-weight path."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import llama3_paper as JP  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.configs import llama3_paper as TP  # noqa: E402
from repro_torch.core.mesh import mesh_and_ctx  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import pad_to, plan_gqa  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from repro_torch.parallel.quant import quantize_model  # noqa: E402
from test_torch_kvquant import (inputs, jax_tree, port_model,  # noqa: E402
                                run_jax, run_port)

torch.set_num_threads(1)

ARCHS = ("mistral-large-123b", "codeqwen1.5-7b", "qwen1.5-32b")
BIAS_ARCHS = ("codeqwen1.5-7b", "qwen1.5-32b")
S, NEW = 8, 3
# f32 decode logits, the same math in another summation order (~1e-6 on
# O(1) logits), as tests/test_torch_wquant.py holds them
TOL = 1e-4


def _same_fields(ours, ref):
    """Every field of the port's ModelConfig is the reference's and equal
    to it (the dtype by its name); the reference's extra fields (a
    training knob, ``max_seq``) have no counterpart in the port."""
    mine = dataclasses.asdict(ours)
    theirs = dataclasses.asdict(ref)
    assert set(mine) <= set(theirs), set(mine) - set(theirs)
    for k, v in mine.items():
        if k == "dtype":
            assert str(v).removeprefix("torch.") == jnp.dtype(
                theirs[k]).name, k
        else:
            assert v == theirs[k], k


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    assert arch in ARCH_IDS
    _same_fields(get_config(arch), JR.get_config(arch))
    _same_fields(get_smoke(arch), JR.get_smoke(arch))
    assert get_config(arch).qkv_bias == (arch in BIAS_ARCHS)


def test_paper_models_and_what_stays_unregistered():
    for name in ("LLAMA31_70B", "LLAMA31_405B"):
        _same_fields(getattr(TP, name), getattr(JP, name))
    assert not {"llama3.1-70b", "llama3.1-405b"} & set(ARCH_IDS)
    for arch in ("whisper-medium", "pixtral-12b"):
        assert arch in ARCH_IDS
        _same_fields(get_config(arch), JR.get_config(arch))
        _same_fields(get_smoke(arch), JR.get_smoke(arch))


def _leaves(cfg) -> int:
    model = TT.init_params(TT.make_plan(cfg, 1), seed=0, device="cpu")
    return sum(p.numel() for p in model.parameters()) + sum(
        t.numel() for b in model.blocks for g in b.children()
        for t in g.values() if not isinstance(t, torch.nn.Parameter))


@pytest.mark.parametrize("arch", ARCHS + ("llama3.2-1b",))
def test_param_count_is_every_leaf(arch):
    """The smoke model's leaves == ``param_count``; at full size the
    reference's count plus what it leaves out (the QKV biases and the
    norms)."""
    cfg = get_smoke(arch)
    assert _leaves(cfg) == cfg.param_count()
    for ours, ref in ((get_config(arch), JR.get_config(arch)),
                      (TP.LLAMA31_405B, JP.LLAMA31_405B)):
        hq, hkv = ours.n_heads * ours.head_dim, ours.n_kv_heads \
            * ours.head_dim
        extra = ours.n_layers * (2 * ours.d_model + ours.qkv_bias
                                 * (hq + 2 * hkv)) + ours.d_model
        assert ours.param_count() == ref.param_count() + extra
    cut = dataclasses.replace(TP.LLAMA31_405B, n_layers=2)
    assert 10.5e9 < cut.param_count() < 10.7e9


def test_init_draws_zero_biases_in_slot_layout():
    """The seeded init's biases are zeros, like the reference's, in each
    rank's slots (qwen1.5's 5 heads at tp=4: 2 slots a rank, 3 dead)."""
    cfg = get_smoke("qwen1.5-32b")
    ap = TT.make_plan(cfg, 4)
    mesh, _ = mesh_and_ctx(4, 2, device="cpu")
    model = TT.init_params(ap, seed=0, device="cpu", mesh=mesh)
    attn = model.blocks[0].attn
    assert attn["bq"].shape == (4, ap.gqa.q_slots_local, cfg.head_dim)
    assert attn["bk"].shape == attn["bv"].shape == (4, ap.gqa.u,
                                                    cfg.head_dim)
    assert not any(attn[n].any() for n in ("bq", "bk", "bv"))
    assert TS.tp_dim(("attn", "bq"), 2) == 0


def _relay(tree, cfg, tp):
    """A tp=1 tree re-laid for the plan at ``tp``: each head moved from
    its tp=1 slot into its slot of the tp plan (dead slots zero), biases
    included, and the vocab zero-padded; one function at either tp."""
    one, many = plan_gqa(cfg.n_heads, cfg.n_kv_heads, 1), \
        plan_gqa(cfg.n_heads, cfg.n_kv_heads, tp)

    def move(a, axis, m1, mn):
        heads = np.take(a, [list(m1).index(h) for h in range(max(m1) + 1)],
                        axis=axis)
        m = np.asarray(mn)
        live = (m >= 0).reshape([-1 if i == axis else 1
                                 for i in range(a.ndim)])
        return np.where(live, np.take(heads, np.maximum(m, 0), axis=axis),
                        0).astype(a.dtype)

    attn = tree["blocks"]["attn"]
    maps = {"q": (one.q_map, many.q_map), "kv": (one.kv_map, many.kv_map)}
    new = {"wo": move(attn["wo"], 1, *maps["q"])}
    for name, axis, m in (("wq", 2, "q"), ("wk", 2, "kv"), ("wv", 2, "kv"),
                          ("bq", 1, "q"), ("bk", 1, "kv"), ("bv", 1, "kv")):
        new[name] = move(attn[name], axis, *maps[m])
    pad = pad_to(cfg.vocab_size, tp) - tree["embed"]["tok"].shape[0]
    return {**tree, "blocks": {**tree["blocks"], "attn": new},
            "embed": {"tok": np.pad(tree["embed"]["tok"], ((0, pad), (0, 0))),
                      "head": np.pad(tree["embed"]["head"],
                                     ((0, 0), (0, pad)))}}


@pytest.fixture(scope="module", params=BIAS_ARCHS)
def biased(request):
    """The JAX tp=1 tree of the arch's f32 smoke config with seeded
    nonzero biases planted, the inputs, and the reference's logits
    (prefill's last, then each teacher-forced decode step's)."""
    arch = request.param
    jcfg = dataclasses.replace(JR.get_smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32)
    tree = jax_tree(jcfg)
    rng = np.random.default_rng(7)
    for n in ("bq", "bk", "bv"):
        a = tree["blocks"]["attn"][n]
        tree["blocks"]["attn"][n] = (rng.standard_normal(a.shape)
                                     * 0.5).astype(np.float32)
    prompts, forced = inputs(jcfg.vocab_size, s=S, new=NEW)
    want, _ = run_jax(jcfg, tree, prompts, forced, S + NEW + 1)
    return dict(tcfg=tcfg, jcfg=jcfg, tree=tree, prompts=prompts,
                forced=forced, want=want)


def test_bias_archs_match_jax_at_tp1_and_2x2(biased):
    """Prefill and teacher-forced decode logits within TOL of the JAX
    steps, at tp=1 and on a 2 x 2 mesh (hier_rd); with the biases zeroed
    the port's logits move far past TOL, so the add is on the path."""
    t, v = biased["tcfg"], biased["tcfg"].vocab_size
    args = (biased["prompts"], biased["forced"], S + NEW + 1)
    for tp, pods in ((1, 1), (4, 2)):
        tree = biased["tree"] if tp == 1 else _relay(biased["tree"], t, tp)
        got, _ = run_port(*port_model(t, tree, tp, pods), *args)
        np.testing.assert_allclose(got[..., :v], biased["want"], atol=TOL,
                                   rtol=0)
    zero = dict(biased["tree"], blocks=dict(biased["tree"]["blocks"], attn={
        n: (np.zeros_like(a) if n in ("bq", "bk", "bv") else a)
        for n, a in biased["tree"]["blocks"]["attn"].items()}))
    got, _ = run_port(*port_model(t, zero), *args)
    assert np.abs(got[..., :v] - biased["want"]).max() > 100 * TOL


def test_bridge_and_int8_weights_keep_the_biases(biased):
    """The bridge cuts each bias over the ranks by its slots; int8 block
    weights leave the biases unquantized, and the weight-quant decode
    (the W8 GEMM through the LayerMap) matches the JAX decode under
    ``layer_map=dequant_layer`` on the same planted tree, on a 2 x 2
    mesh."""
    t, v = biased["tcfg"], biased["tcfg"].vocab_size
    tree4 = _relay(biased["tree"], t, 4)
    ap, model, ctx, mesh = port_model(t, tree4, 4, 2)
    for n in ("bq", "bk", "bv"):
        want = np.stack(np.split(tree4["blocks"]["attn"][n][1], 4, axis=0))
        np.testing.assert_array_equal(
            model.blocks[1].attn[n].numpy(), want)
        q = quantize_model(model).blocks[1].attn[n]
        assert isinstance(q, torch.Tensor) and torch.equal(
            q, model.blocks[1].attn[n])
    if t.name != "codeqwen-smoke":       # one arch is enough for the GEMM
        return
    args = (biased["prompts"], biased["forced"], S + NEW + 1)
    want, _ = run_jax(biased["jcfg"], biased["tree"], *args,
                      weight_quant=True)
    got, _ = run_port(ap, model, ctx, mesh, *args, weight_quant=True)
    np.testing.assert_allclose(got[..., :v], want, atol=TOL, rtol=0)
