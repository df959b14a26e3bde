"""The bf16 grouped expert FFN kernel's split plan (``kernels/moe_gemm/
ops.py::tc_plan``) and its plain split form (``ref.py::
moe_expert_ffn_split_ref``: F in slices, h of a slice rounded to the
operand type, the slices' f32 down products summed in ascending order),
held against the JAX package on the same inputs, made with numpy from a
seed: the kernel's oracle ``repro/kernels/moe_gemm/ref.py``, its Pallas
kernel in interpret mode, and the model layer's bf16 expert FFN
``repro/models/moe.py::_expert_ffn``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gemm import (moe_expert_ffn as pallas_ffn,  # noqa: E402
                                    moe_expert_ffn_ref as jax_ffn_ref)
from repro.models import moe as JM  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_gemm import (  # noqa: E402
    moe_expert_ffn, moe_expert_ffn_ref, moe_expert_ffn_split_ref)

torch.set_num_threads(1)

# (E, C, D, F): one slice, a whole and a ragged second slice, three with a
# ragged last one, and widths off the 16-byte path.
SPLIT_CASES = [(2, 8, 64, 200), (2, 12, 48, 512), (3, 20, 32, 600),
               (3, 13, 72, 50)]


def _operands(E, C, D, F, seed, G=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G or E, C, D)).astype(np.float32),
            (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
            (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
            (rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32))


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}x{c[3]}"
                              for c in SPLIT_CASES])
def test_split_form_matches_jax_oracle(case):
    """In f32 the split form is the oracle's function in another sum
    order (the slices' partials added in turn): 1e-5."""
    ops = _operands(*case, seed=sum(case))
    want = np.asarray(jax_ffn_ref(*(jnp.asarray(a) for a in ops)))
    got = moe_expert_ffn_split_ref(*(torch.tensor(a) for a in ops))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_split_form_matches_pallas_interpret():
    """One case against the TPU kernel itself in interpret mode, with F
    past one slice (C and F padded by its wrapper to the 128 tiles)."""
    ops = _operands(2, 16, 64, 300, seed=11)
    want = np.asarray(pallas_ffn(*(jnp.asarray(a) for a in ops),
                                 interpret=True))
    got = moe_expert_ffn_split_ref(*(torch.tensor(a) for a in ops))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_bf16_split_form_matches_the_model_layer():
    """In bf16 the split form rounds h once to bf16, as the model layer's
    bf16 einsums do (``_expert_ffn``: a, b, silu(a), h and the output each
    rounded to bf16; the Pallas kernel and the oracle keep h in f32).  The
    tolerance is kernel 7's TOL (3e-2): two bf16 roundings of outputs of
    size ~1 and the layer's extra roundings of a, b and silu(a) (each a
    relative 2^-9), summed over F; measured 9.8e-3 here (|out| up to
    2.5)."""
    E, C, D, F = 2, 8, 64, 600
    ops = _operands(E, C, D, F, seed=5)
    p = {k: jnp.asarray(a, jnp.bfloat16)
         for k, a in zip(("wg", "wu", "wd"), ops[1:])}
    want = np.asarray(JM._expert_ffn(p, jnp.asarray(ops[0], jnp.bfloat16)),
                      np.float32)
    bf = tuple(torch.tensor(a).to(torch.bfloat16) for a in ops)
    got = moe_expert_ffn_split_ref(*bf)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)
    # h rounded to bf16 is a different function from the f32-h oracle's
    assert not torch.equal(got, moe_expert_ffn_ref(*bf))


@pytest.mark.parametrize("C", [1, 5, 8, 13, 24, 40, 41, 80, 100, 128, 256])
@pytest.mark.parametrize("F", [24, 256, 768, 10752])
def test_tc_plan_covers_c_and_f_once(C, F):
    """Slices of ``SLICE_F`` cover F once and token tiles of a multiple of
    8 rows (at most 40) cover C once, in as few tiles as C needs."""
    plan = moe_ops.tc_plan(C, F)
    assert plan.slice_f == moe_ops.SLICE_F == 256
    assert (plan.n_split - 1) * plan.slice_f < F <= plan.n_split * plan.slice_f
    assert plan.tile_c % 8 == 0 and 8 <= plan.tile_c <= 40
    assert (plan.n_tiles - 1) * plan.tile_c < C <= plan.n_tiles * plan.tile_c
    assert plan.n_tiles == -(-C // 40)
    assert plan.smem <= moe_ops.MAX_SMEM // 2         # two CTAs an SM


def test_tc_plan_of_the_path_shapes():
    """qwen3-moe decode: 3 slices x 1 tile of 8 rows (384 CTAs, 25 MB of
    partials); its prefill dispatch: 3 x 2 tiles of 40; dbrx-132b: 42
    slices.  Any D: the plan does not take it, and the workspace grows
    with it."""
    assert moe_ops.tc_plan(8, 768) == moe_ops.TcPlan(256, 3, 8, 1, 73344)
    assert moe_ops.tc_plan(80, 768) == moe_ops.TcPlan(256, 3, 40, 2, 96384)
    assert moe_ops.tc_plan(8, 10752).n_split == 42
    assert moe_ops.workspace_floats(128, 8, 2048, 768) * 4 == 25165824
    for D in (40, 2048, 6144, 8192):
        assert moe_ops.workspace_floats(4, 8, D, 10752) == 4 * 42 * 8 * D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_form_one_block_equals_e_copies(dtype):
    """The plan never looks at G: one token block shared by every expert
    gives bitwise what E copies of it give."""
    E = 4
    x, wg, wu, wd = (torch.tensor(a).to(dtype)
                     for a in _operands(E, 8, 32, 300, seed=2, G=1))
    one = moe_expert_ffn_split_ref(x, wg, wu, wd)
    copies = moe_expert_ffn_split_ref(x.expand(E, -1, -1).contiguous(), wg,
                                      wu, wd)
    assert torch.equal(one, copies)


def test_cpu_wrapper_keeps_the_plain_version():
    """On the CPU the wrapper runs the oracle's plain version (h in f32)
    and launches nothing, in either dtype."""
    before = moe_expert_ffn.launches
    for dtype in (torch.float32, torch.bfloat16):
        ops = tuple(torch.tensor(a).to(dtype)
                    for a in _operands(2, 5, 24, 300, seed=4))
        assert torch.equal(moe_expert_ffn(*ops), moe_expert_ffn_ref(*ops))
    assert moe_expert_ffn.launches == before
