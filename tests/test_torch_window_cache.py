"""The port's ring-buffer window cache (``window_cache``) held against the
JAX package and against the port's own full cache: hymba-1.5b's smoke
config (window 8) decoded past its window at tp=1 against the reference's
``decode_step(kv_ring=True)``, ring == full cache in the port (greedy
tokens equal, logits within 1e-5), a sliding-window dense config at tp=4
on the virtual mesh against the reference's tp=1 ring, and the layouts
the ring refuses.  Smoke sizes, f32."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from test_torch_kvquant import (TINY, inputs, jax_tree,  # noqa: E402
                                port_model, run_jax, run_port, tiny_cfgs)

torch.set_num_threads(1)

WINDOW = 8
S, NEW = 6, 12            # positions up to 17: past the window twice
# f32: the ring holds the same keys as the full cache's window in another
# slot order, so softmax sums run in another order: ~1e-6 on O(1) logits.
RING_TOL = 1e-5


@pytest.fixture(scope="module")
def hymba():
    jcfg = dataclasses.replace(jax_smoke("hymba-1.5b"), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke("hymba-1.5b"), dtype=torch.float32)
    assert tcfg.sliding_window == WINDOW
    return dict(jcfg=jcfg, tcfg=tcfg, tree=jax_tree(jcfg))


def _greedy(ap, model, prompts, s_max, ring):
    """Greedy decode of NEW tokens on the ring or the full cache: (tokens
    (B, NEW), logits (B, NEW, V))."""
    b, s = prompts.shape
    with torch.inference_mode():
        lg, st = TT.forward_lm(model, torch.tensor(prompts).long(), ap,
                               collect_state=True)
        cache = TT.seed_cache(TT.init_cache(ap, b, s_max, device="cpu",
                                            window_cache=ring), st)
        assert cache["k"].shape[2] == (WINDOW if ring else s_max)
        tok = lg[:, -1, :ap.cfg.vocab_size].argmax(-1)
        toks, out = [tok], []
        for i in range(NEW - 1):
            d, cache = TT.decode_step(model, cache, tok,
                                      torch.full((b,), s + i,
                                                 dtype=torch.int32), ap,
                                      kv_ring=ring)
            tok = d[:, :ap.cfg.vocab_size].argmax(-1)
            toks.append(tok)
            out.append(d.float().numpy())
    return torch.stack(toks, 1).numpy(), np.stack(out, 1)


def test_hymba_ring_matches_jax_and_the_full_cache(hymba):
    """Teacher-forced past the window: the port's ring logits within
    RING_TOL of the reference's ring; greedy, the port's ring gives the
    full cache's tokens and logits within RING_TOL."""
    prompts, forced = inputs(hymba["tcfg"].vocab_size, seed=6, s=S, new=NEW)
    s_max = S + NEW + 2
    want, _ = run_jax(hymba["jcfg"], hymba["tree"], prompts, forced, s_max,
                      window_cache=True)
    run = port_model(hymba["tcfg"], hymba["tree"])
    got, cache = run_port(*run, prompts, forced, s_max, window_cache=True)
    assert cache["k"].shape[2] == WINDOW
    v = hymba["tcfg"].vocab_size
    np.testing.assert_allclose(got[..., :v], want, atol=RING_TOL, rtol=0)
    ap, model = run[0], run[1]
    t_ring, l_ring = _greedy(ap, model, prompts, s_max, True)
    t_full, l_full = _greedy(ap, model, prompts, s_max, False)
    np.testing.assert_array_equal(t_ring, t_full)
    np.testing.assert_allclose(l_ring, l_full, atol=RING_TOL, rtol=0)


def test_sliding_window_dense_ring_at_tp4_matches_jax():
    """A sliding-window dense config on a 2 x 2 mesh (hier_rd), the ring
    of every rank's kv head, against the reference's tp=1 ring."""
    jcfg, tcfg = tiny_cfgs(sliding_window=WINDOW)
    tree = jax_tree(jcfg)
    prompts, forced = inputs(TINY["vocab_size"], seed=7, s=S, new=NEW)
    s_max = S + NEW + 2
    want, _ = run_jax(jcfg, tree, prompts, forced, s_max, window_cache=True)
    got, _ = run_port(*port_model(tcfg, tree, 4, 2), prompts, forced, s_max,
                      window_cache=True)
    np.testing.assert_allclose(got[..., :TINY["vocab_size"]], want,
                               atol=RING_TOL, rtol=0)


def test_ring_refusals(hymba):
    """The ring needs a sliding-window arch and the dense layout, and a
    prompt must fit it (the reference's dynamic_update_slice cannot take a
    longer one either)."""
    ap = TT.make_plan(hymba["tcfg"], 1)
    with pytest.raises(ValueError, match="incompatible with kv_quant/window"):
        TT.init_cache(ap, 2, 16, block_size=8, device="cpu",
                      window_cache=True)
    _, tcfg = tiny_cfgs()
    with pytest.raises(ValueError, match="sliding-window arch"):
        TT.init_cache(TT.make_plan(tcfg, 1), 2, 16, device="cpu",
                      window_cache=True)
    cache = TT.init_cache(ap, 1, 64, device="cpu", window_cache=True)
    states = {n: torch.zeros((2, 1, WINDOW + 1, 5, 16)) for n in "kv"}
    with pytest.raises(ValueError, match="does not fit"):
        TT.seed_cache(cache, states, slot=0)
