"""The port's batched generation (the slice as a whole) held against the
JAX package's ``InferenceEngine.generate`` on bridged parameters, plus the
port's own invariants (paged == dense, seeded sampling, the card as the
default device)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.pcontext import LOCAL  # noqa: E402
from repro.inference.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

B, S, NEW, S_MAX, BLOCK = 3, 12, 8, 24, 8
# Logit tolerance of the margin gate, as tests/test_torch_model.py: where
# the JAX top-1/top-2 gap is within 2*(atol + rtol*|logit|) the two
# frameworks' bf16 roundings may pick different tokens.
BF16_TOL = 5e-2


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dt = request.param
    jcfg = dataclasses.replace(jax_smoke("llama3.2-1b"), dtype=getattr(jnp, dt))
    tcfg = dataclasses.replace(get_smoke("llama3.2-1b"),
                               dtype=getattr(torch, dt))
    jap, tap = JT.make_plan(jcfg, 1), TT.make_plan(tcfg, 1)
    params = jax.jit(JT.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jap)
    model = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return dt, jap, params, tap, model


def _prompts(vocab):
    return np.random.default_rng(5).integers(0, vocab, (B, S))


def _margin_gate(ours, ref, ref_logits, tol):
    """Tokens must match at every step until the first one whose reference
    top-1/top-2 gap is within the tolerance; returns the steps checked."""
    lf = np.asarray(ref_logits, np.float32)
    top2 = -np.sort(-lf, axis=-1)[..., :2]
    gap = top2[..., 0] - top2[..., 1]
    thresh = 2 * (tol + tol * np.abs(top2[..., 0]))
    checked = 0
    for b in range(ours.shape[0]):
        for t in range(NEW):
            i = S - 1 + t                     # logits that chose token S+t
            if gap[b, i] <= thresh[b, i]:
                break
            assert ours[b, S + t] == ref[b, S + t], (b, t, gap[b, i])
            checked += 1
    return checked


@pytest.mark.parametrize("block_size", [0, BLOCK], ids=["dense", "paged"])
def test_generate_matches_jax_engine(models, block_size):
    dt, jap, params, tap, model = models
    prompts = _prompts(tap.cfg.vocab_size)
    ref = JaxEngine(jap, params, s_max=S_MAX, block_size=block_size
                    ).generate(prompts, NEW)
    ours = InferenceEngine(tap, model, s_max=S_MAX, block_size=block_size,
                           device="cpu").generate(prompts, NEW)
    assert ours.tokens.shape == ref.tokens.shape == (B, S + NEW)
    assert ours.new_tokens.dtype == np.int32 and ours.steps == NEW
    np.testing.assert_array_equal(ours.tokens[:, :S], prompts)
    if dt == "float32":
        np.testing.assert_array_equal(ours.tokens, ref.tokens)
        return
    logits = JT.forward_lm(params, jnp.asarray(ref.tokens[:, :-1]), jap,
                           LOCAL)[0]
    assert _margin_gate(ours.tokens, ref.tokens, logits, BF16_TOL) >= B


def test_paged_generate_equals_dense(models):
    _, _, _, tap, model = models
    prompts = _prompts(tap.cfg.vocab_size)
    dense, paged = (InferenceEngine(tap, model, s_max=S_MAX, block_size=bs,
                                    device="cpu").generate(prompts, NEW)
                    for bs in (0, BLOCK))
    np.testing.assert_array_equal(paged.tokens, dense.tokens)


def test_sampling_is_seeded():
    tap = TT.make_plan(get_smoke("llama3.2-1b"), 1)
    model = TT.init_params(tap, seed=1, device="cpu")
    prompts = _prompts(tap.cfg.vocab_size)

    def run(seed, **kw):
        return InferenceEngine(tap, model, s_max=S_MAX, seed=seed,
                               device="cpu", **kw).generate(prompts, NEW)

    a = run(3, temperature=1.0, top_k=5)
    b = run(3, temperature=1.0, top_k=5)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.new_tokens.max() < tap.cfg.vocab_size
    greedy = run(0)
    np.testing.assert_array_equal(run(7, temperature=1.0, top_k=1).tokens,
                                  greedy.tokens)
    with pytest.raises(ValueError, match="s_max"):
        InferenceEngine(tap, model, s_max=S + NEW - 1,
                        device="cpu").generate(prompts, NEW)


def test_card_is_the_default_device():
    """device=None means CUDA; without a card the engine and the CLI raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    tap = TT.make_plan(get_smoke("llama3.2-1b"), 1)
    model = TT.init_params(tap, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(tap, model, s_max=S_MAX)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "llama3.2-1b", "--mode", "batch"])


def test_serve_cli_batch_on_cpu(capsys):
    res = serve.main(["--arch", "llama3.2-1b", "--mode", "batch",
                      "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--max-new", "4", "--block-size", "8"])
    assert res.new_tokens.shape == (2, 4)
    assert "paged(bs=8)" in capsys.readouterr().out
