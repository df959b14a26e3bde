"""The port's attention kernel wrappers (CPU tensors: their plain PyTorch
versions) held against the JAX package: its ``ref.py`` oracles over a
subset of tests/test_kernels.py's shapes, and its Pallas kernels in
interpret mode for one case each.  The CUDA kernels themselves run only on
the card (chip_smoke.py holds them against these plain versions there)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jdec  # noqa: E402
from repro.kernels import flash_attention as jflash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import (decode_attention,  # noqa: E402
                                 flash_attention, kernel_wrappers,
                                 paged_decode_attention)
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(1)


def _tol(dt):
    # as tests/test_kernels.py: f32-accumulate tolerance, and one bf16
    # rounding of the output (both sides accumulate in f32)
    return 3e-2 if dt == "bfloat16" else 3e-5


def _pair(r, shape, dt):
    """The same values as a JAX array and a CPU torch tensor (bf16 rounds
    the same float32 draws in both)."""
    x = r.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dt)),
            torch.tensor(x).to(getattr(torch, dt)))


# The JAX oracles, compiled once per shape rather than op by op.
_flash_ref = jax.jit(jflash.flash_attention_ref,
                     static_argnames=("causal", "window"))
_decode_ref = jax.jit(jdec.decode_attention_ref, static_argnames=("window",))
_paged_ref = jax.jit(jdec.paged_decode_attention_ref,
                     static_argnames=("window",))


def _close(t, j, dt):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=_tol(dt), rtol=_tol(dt))


# (B, Hq, Hkv, Sq, Skv, hd, causal, window, dtype)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, 0, "float32"),     # GQA
    (1, 4, 1, 200, 200, 64, True, 0, "float32"),     # ragged length
    (2, 2, 2, 256, 256, 128, True, 64, "bfloat16"),  # sliding window
    (1, 8, 2, 128, 384, 64, False, 0, "float32"),    # non-causal
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"case{i}" for i in range(len(FLASH_CASES))])
def test_flash_attention_vs_jax_ref(case):
    B, Hq, Hkv, Sq, Skv, hd, causal, window, dt = case
    r = np.random.default_rng(1)
    qj, qt = _pair(r, (B, Hq, Sq, hd), dt)
    kj, kt = _pair(r, (B, Hkv, Skv, hd), dt)
    vj, vt = _pair(r, (B, Hkv, Skv, hd), dt)
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.shape == (B, Hq, Sq, hd) and out.dtype == qt.dtype
    _close(out, _flash_ref(qj, kj, vj, causal=causal, window=window), dt)


def test_flash_attention_vs_pallas_interpret():
    r = np.random.default_rng(2)
    qj, qt = _pair(r, (1, 4, 160, 64), "float32")
    kj, kt = _pair(r, (1, 2, 160, 64), "float32")
    vj, vt = _pair(r, (1, 2, 160, 64), "float32")
    _close(flash_attention(qt, kt, vt, causal=True),
           jflash.flash_attention(qj, kj, vj, causal=True, interpret=True),
           "float32")


# (B, Hq, Hkv, S, hd, window, dtype)
DECODE_CASES = [
    (4, 4, 2, 512, 64, 0, "float32"),
    (3, 8, 1, 300, 128, 0, "float32"),
    (8, 2, 2, 1024, 64, 128, "bfloat16"),
]


def _decode_inputs(r, B, Hq, Hkv, S, hd, dt):
    qj, qt = _pair(r, (B, Hq, hd), dt)
    kj, kt = _pair(r, (B, S, Hkv, hd), dt)
    vj, vt = _pair(r, (B, S, Hkv, hd), dt)
    pos = r.integers(0, S, B).astype(np.int32)
    return (qj, kj, vj, jnp.asarray(pos)), (qt, kt, vt, torch.tensor(pos))


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"case{i}" for i in range(len(DECODE_CASES))])
def test_decode_attention_vs_jax_ref(case):
    B, Hq, Hkv, S, hd, window, dt = case
    j, t = _decode_inputs(np.random.default_rng(3), B, Hq, Hkv, S, hd, dt)
    out = decode_attention(*t, window=window)
    assert out.shape == (B, Hq, hd) and out.dtype == t[0].dtype
    _close(out, _decode_ref(*j, window=window), dt)


def test_decode_attention_vs_pallas_interpret():
    j, t = _decode_inputs(np.random.default_rng(4), 3, 4, 2, 256, 64,
                          "float32")
    _close(decode_attention(*t), jdec.decode_attention(*j, interpret=True),
           "float32")


def test_decode_attention_ignores_keys_past_position():
    """Scrubbing every key/value past pos changes nothing."""
    r = np.random.default_rng(5)
    _, (q, k, v, _) = _decode_inputs(r, 2, 2, 1, 256, 64, "float32")
    for p in (0, 17, 255):
        pos = torch.full((2,), p, dtype=torch.int32)
        keep = (torch.arange(256) <= p)[None, :, None, None]
        out1 = decode_attention(q, k, v, pos)
        out2 = decode_attention(q, torch.where(keep, k, 999.0),
                                torch.where(keep, v, -999.0), pos)
        assert torch.equal(out1, out2)


# (B, Hq, Hkv, bs, max_blocks, n_blocks, hd, window, dtype)
PAGED_CASES = [
    (4, 4, 2, 16, 8, 40, 64, 0, "float32"),
    (3, 8, 1, 32, 4, 16, 128, 0, "float32"),
    (2, 2, 2, 64, 4, 12, 64, 128, "bfloat16"),   # sliding window
]


def _paged_inputs(r, B, Hq, Hkv, bs, mb, nb, hd, dt):
    qj, qt = _pair(r, (B, Hq, hd), dt)
    kj, kt = _pair(r, (nb, bs, Hkv, hd), dt)
    vj, vt = _pair(r, (nb, bs, Hkv, hd), dt)
    # collision-free logical -> physical map; block 0 is the trash block
    tbl = (1 + r.permutation(nb - 1)[:B * mb].reshape(B, mb)).astype(np.int32)
    pos = r.integers(0, mb * bs, B).astype(np.int32)
    return ((qj, kj, vj, jnp.asarray(tbl), jnp.asarray(pos)),
            (qt, kt, vt, torch.tensor(tbl), torch.tensor(pos)))


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=[f"case{i}" for i in range(len(PAGED_CASES))])
def test_paged_decode_attention_vs_jax_ref(case):
    B, Hq, Hkv, bs, mb, nb, hd, window, dt = case
    j, t = _paged_inputs(np.random.default_rng(6), B, Hq, Hkv, bs, mb, nb,
                         hd, dt)
    out = paged_decode_attention(*t, window=window)
    _close(out, _paged_ref(*j, window=window), dt)


def test_paged_decode_attention_vs_pallas_interpret():
    j, t = _paged_inputs(np.random.default_rng(7), 2, 4, 2, 16, 3, 8, 64,
                         "float32")
    _close(paged_decode_attention(*t),
           jdec.paged_decode_attention(*j, interpret=True), "float32")


def test_paged_decode_attention_trash_isolation():
    """Scribbling on the trash block (0) and on blocks no table row maps
    leaves the output bitwise unchanged."""
    r = np.random.default_rng(11)
    _, (q, k, v, tbl, _) = _paged_inputs(r, 2, 2, 1, 16, 4, 32, 64,
                                         "float32")
    pos = torch.tensor([30, 61], dtype=torch.int32)
    out1 = paged_decode_attention(q, k, v, tbl, pos)
    dead = np.setdiff1d(np.arange(32), np.unique(tbl.numpy()))
    k2, v2 = k.clone(), v.clone()
    k2[dead], v2[dead] = 999.0, -999.0
    assert torch.equal(out1, paged_decode_attention(q, k2, v2, tbl, pos))


def test_paged_matches_dense_on_gathered_view():
    r = np.random.default_rng(8)
    _, (q, k, v, tbl, pos) = _paged_inputs(r, 3, 4, 2, 32, 4, 16, 64,
                                           "float32")
    k_log = k[tbl.long()].reshape(3, 128, 2, 64)
    v_log = v[tbl.long()].reshape(3, 128, 2, 64)
    torch.testing.assert_close(paged_decode_attention(q, k, v, tbl, pos),
                               decode_attention(q, k_log, v_log, pos),
                               atol=0, rtol=0)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_mask_matches_jax(causal, window):
    qp = np.arange(12, dtype=np.int32)
    kp = np.arange(15, dtype=np.int32)
    got = TL._mask(torch.tensor(qp), torch.tensor(kp), causal=causal,
                   window=window)
    want = JL._mask(jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                    window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_refuse_non_cpu_tensors_they_cannot_launch():
    """A tensor off the CPU never takes the plain version: it launches the
    CUDA kernel or the wrapper raises (here: a meta tensor), and the
    launch counters move only on a launch."""
    before = [w.launches for w in kernel_wrappers()]
    q = torch.empty((1, 2, 8, 64), device="meta")
    kv = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, kv, kv)
    qd = torch.empty((1, 2, 64), device="meta")
    kd = torch.empty((1, 8, 1, 64), device="meta")
    pos = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(qd, kd, kd, pos)
    tbl = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(qd, kd, kd, tbl, pos)
    assert [w.launches for w in kernel_wrappers()] == before


def test_attention_operand_layouts_the_kernels_take():
    """What the attention wrappers refuse before a launch: a type other
    than f32/bf16, a head dim outside 16-128, a head dim that is not
    contiguous, rows that do not start on 16-byte boundaries (the bf16
    flash kernel copies 16-byte row pieces into shared memory), mixed
    types.  The model's (B, S, H, hd) views transposed to (B, H, S, hd)
    pass."""
    from repro_torch.kernels._checks import check_operands, layout_error
    hds = (16, 32, 64, 128)
    q = torch.zeros((2, 12, 4, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert layout_error((q, q), hds) is None
    assert layout_error((q.float(), q.float()), hds) is None
    assert "dtype" in layout_error((q.half(),), hds)
    assert "head dim" in layout_error((q[..., :48],), hds)
    square = torch.zeros((2, 4, 16, 16), dtype=torch.bfloat16)
    assert "strides" in layout_error((square.transpose(2, 3),), hds)
    odd = torch.zeros((2, 12, 4, 68), dtype=torch.bfloat16)[..., :64]
    assert "strides" in layout_error((odd.transpose(1, 2),), hds)
    assert "strides" not in (layout_error(
        (torch.zeros((2, 12, 4, 68))[..., :64],), hds) or "")
    off = torch.zeros(2 * 4 * 12 * 64 + 1, dtype=torch.bfloat16)[1:]
    assert "aligned" in layout_error((off.view(2, 4, 12, 64),), hds)
    assert "share" in layout_error((q, q.float()), hds)
    with pytest.raises(ValueError, match="CUDA"):
        check_operands("flash_attention", (q,), hds)


def test_build_names_each_library_by_its_sources(tmp_path, monkeypatch):
    """A library's file name carries a hash of its source and the shared
    headers, so an edited source is rebuilt and an unchanged one reused."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("int a;")
    (csrc / "common.cuh").write_text("// v1")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build._target(csrc / "a.cu")
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("a-") and first.suffix == ".so"
    assert _build._target(csrc / "a.cu") == first
    (csrc / "common.cuh").write_text("// v2")
    second = _build._target(csrc / "a.cu")
    (csrc / "a.cu").write_text("int b;")
    assert len({first, second, _build._target(csrc / "a.cu")}) == 3


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
