"""The split-KV plan of the decode-attention kernels (kernels 1 and 2,
``csrc/decode_attention.cu``) and its plain split form, held against the
JAX package's oracles.  The kernel cuts each row's cache into splits of
``SPLIT_KEYS`` keys at multiples of it, one partial (m, l, acc) a split,
then merges a row's live splits in ascending order; the split form does
the same in plain PyTorch, so these tests check the arithmetic of the
plan on the CPU (the kernels themselves run only on the card, where
chip_smoke.py holds them against the plain versions)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jdec  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, decode_attention_split_ref,
    paged_decode_attention_split_ref)

torch.set_num_threads(1)

SPLIT = ops.SPLIT_KEYS
S = 2 * SPLIT + 64
# a row at each split boundary, the first key and the last
POSITIONS = [0, SPLIT - 1, SPLIT, 2 * SPLIT - 1, S - 1]
TOL = 1e-5   # f32: the split form's sums run in another order

_decode_ref = jax.jit(jdec.decode_attention_ref, static_argnames=("window",))
_paged_ref = jax.jit(jdec.paged_decode_attention_ref,
                     static_argnames=("window",))


def _draw(r, shape):
    return r.standard_normal(shape).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


# (g, hd, Hkv, window): g 1, 5 and 8; hd 16, 64 and 128; windows that
# start mid-split (pos 319 - 100 + 1 = 220 in split 1; 255 - 200 + 1 = 56)
SPLIT_CASES = [(1, 16, 2, 0), (5, 64, 1, 0), (8, 128, 1, 0),
               (4, 32, 2, 100), (5, 64, 1, 200)]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"g{c[0]}-hd{c[1]}-w{c[3]}"
                              for c in SPLIT_CASES])
def test_split_form_vs_jax_ref(case):
    g, hd, Hkv, window = case
    r = np.random.default_rng(31)
    B = len(POSITIONS)
    q, k, v = (_draw(r, (B, Hkv * g, hd)), _draw(r, (B, S, Hkv, hd)),
               _draw(r, (B, S, Hkv, hd)))
    pos = np.array(POSITIONS, np.int32)
    got = decode_attention_split_ref(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(pos),
        window=window, split=SPLIT)
    _close(got, _decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos), window=window))
    # and the CPU path (the port's plain version) agrees
    _close(got, decode_attention_ref(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), torch.tensor(pos),
                                     window=window))


@pytest.mark.parametrize("bs", [16, 32, 48],
                         ids=["bs16", "bs32", "bs48-not-dividing"])
def test_paged_split_form_vs_jax_ref(bs):
    """Block sizes that divide the split length and one that does not: a
    split then starts inside a block."""
    r = np.random.default_rng(32)
    g, hd, Hkv, window = 5, 64, 1, 150
    B, mb = len(POSITIONS), -(-S // bs)
    nb = B * mb + 1
    q = _draw(r, (B, Hkv * g, hd))
    kp, vp = _draw(r, (nb, bs, Hkv, hd)), _draw(r, (nb, bs, Hkv, hd))
    # collision-free logical -> physical map; block 0 is the trash block
    tbl = (1 + r.permutation(nb - 1)).reshape(B, mb).astype(np.int32)
    pos = np.array(POSITIONS, np.int32)
    got = paged_decode_attention_split_ref(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(tbl), torch.tensor(pos), window=window, split=SPLIT)
    _close(got, _paged_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(tbl), jnp.asarray(pos),
                           window=window))


def test_split_form_row_without_keys_gives_zeros():
    """pos = -1: no live split, zeros (the kernels' documented output;
    the JAX oracle averages every value row there); the other rows are
    untouched."""
    r = np.random.default_rng(33)
    q, k, v = (torch.tensor(_draw(r, (3, 4, 32))),
               torch.tensor(_draw(r, (3, S, 2, 32))),
               torch.tensor(_draw(r, (3, S, 2, 32))))
    pos = torch.tensor([-1, SPLIT, -1], dtype=torch.int32)
    got = decode_attention_split_ref(q, k, v, pos, split=SPLIT)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    _close(got[1:2], decode_attention_ref(q[1:2], k[1:2], v[1:2], pos[1:2]))


def test_split_plan():
    """Live splits per row, boundaries at multiples of the split length,
    the grid and the workspace."""
    plan = ops.split_plan(POSITIONS + [-1], S, Hq=8, Hkv=2, hd=64)
    assert plan.split == SPLIT and plan.n_splits == 3
    assert plan.live == (range(0, 1), range(0, 1), range(0, 2), range(0, 2),
                         range(0, 3), range(0))
    g = 4
    assert plan.workspace == 6 * 2 * 3 * (g * 64 + 2 * g)
    # with a window, the first live split is the one holding pos - w + 1
    win = ops.split_plan([SPLIT + 70, 2 * SPLIT + 5, S - 1], S, Hq=8, Hkv=2,
                         hd=64, window=SPLIT // 2)
    assert win.live == (range(1, 2), range(1, 3), range(2, 3))
    for pos, live in zip(POSITIONS, plan.live):
        first, last = ops.visible_keys(pos, S, 0)
        # every live split holds a visible key; its neighbours hold none
        for j in live:
            assert j * SPLIT <= last and j * SPLIT + SPLIT - 1 >= first
        assert live.start * SPLIT <= first < (live.start + 1) * SPLIT
        assert (live.stop - 1) * SPLIT <= last < live.stop * SPLIT
    # a position past the cache clamps to its last key
    assert ops.live_splits(S + 5, S, 0, SPLIT) == range(0, 3)


@pytest.mark.parametrize("bs", [16, 48])
def test_split_plan_dense_equals_paged(bs):
    """A row's live splits depend on its position, the window and the
    split length only: the same for the dense cache of S keys and the
    paged one of bs * max_blocks keys, for any batch."""
    mb = -(-S // bs)
    for window in (0, 100):
        dense = ops.split_plan(POSITIONS, S, Hq=4, Hkv=1, hd=32,
                               window=window)
        paged = ops.split_plan(POSITIONS, bs * mb, Hq=4, Hkv=1, hd=32,
                               window=window)
        assert dense.live == paged.live
        one = [ops.split_plan([p], S, Hq=4, Hkv=1, hd=32,
                              window=window).live[0] for p in POSITIONS]
        assert tuple(one) == dense.live
