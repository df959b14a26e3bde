"""The port's training path (ROADMAP item 11, part one: the dense family
at tp=1 and data-parallel over the pods of a virtual mesh) held against
the JAX package in-process (no subprocess, no ``XLA_FLAGS``).

The reference's tiny dense config of ``tests/dist_cases/
case_train_parity.py`` in f32, the JAX ``init_params`` tree bridged to the
port.  The optimizer, the data pipeline, kernel 3 under autograd and
``sharded_xent``, the R = 1 train step against the reference's
``build_train_step`` on a 1 x 1 ("data", "model") mesh, the data-parallel
update against the reference's ``grad_cross_pod_reduce``,
``global_grad_norm`` and ``adamw_update`` under ``jax.vmap(axis_name=
"pod")``, remat and microbatching, the NaN skip, checkpoints both ways,
resume and preemption, and the refusals."""
import dataclasses
import os
import signal
import threading
import time
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import hierarchical as JH  # noqa: E402
from repro.core.pcontext import LOCAL as JLOCAL  # noqa: E402
from repro.core.pcontext import ParallelCtx as JCtx  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel.steps import build_train_step as jax_train_step  # noqa
from repro.training import checkpoint as jck  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.mesh import VirtualMesh  # noqa: E402
from repro_torch.core.pcontext import ParallelCtx, single_pod_ctx  # noqa
from repro_torch.kernels.flash_attention import autograd as FA  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import (params_from_numpy,  # noqa: E402
                                       params_to_numpy, stack_layers)
from repro_torch.parallel.steps import (build_train_step,  # noqa: E402
                                        train_state)
from repro_torch.training import checkpoint as tck  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from test_torch_kvquant import FAST_COMPILE, jax_tree  # noqa: E402

torch.set_num_threads(1)

# case_train_parity.py::tiny("dense"), f32; its batch is 8 x 16.
TINY = dict(family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=96)
B, S = 8, 16
LR = dict(base_lr=1e-2, warmup=1, total_steps=10)
# f32 throughout: the two packages sum in other orders (XLA's fusions,
# cuBLAS-free CPU matmuls), ~1e-7 relative an operation.
OPT_TOL = 1e-6
STEP_TOL = 1e-4
TRAJ_TOL = 1e-3
# The reference's int8 scale is ``absmax / 127``, which XLA's algebraic
# simplifier turns into a multiply by 1/127 (an ulp off the quotient the
# port divides out); without the pass both packages take the same int8
# steps (test_torch_quant_collectives.py compiles so too).
NO_ALGSIMP = {**FAST_COMPILE, "xla_disable_hlo_passes": "algsimp"}


@pytest.fixture(scope="module")
def tiny():
    jcfg = JC.ModelConfig(name="t", dtype=jnp.float32, **TINY)
    tcfg = TC.ModelConfig(name="t", dtype=torch.float32, **TINY)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 96, (B, S)).astype(np.int32),
             "labels": rng.integers(0, 96, (B, S)).astype(np.int32)}
    return jcfg, tcfg, jax_tree(jcfg), batch


def _port_model(tcfg, tree, pods=1):
    m = params_from_numpy(tree, tcfg, "cpu")
    return TT.data_parallel(m, pods) if pods > 1 else m


def _rand_tree(tree, rng, lead=(), positive=False):
    def f(a):
        x = rng.standard_normal(lead + np.shape(a)).astype(np.float32)
        return np.abs(x) * 1e-2 if positive else x * 1e-2
    return jax.tree.map(f, tree)


def _t(tree, ranked=False):
    """A numpy tree in the reference's layout (blocks on a leading layer
    axis; ``ranked``: behind a leading pod axis) as the port's tree of
    tensors (blocks a list of layers)."""
    def layer(a, i):
        return torch.tensor(np.ascontiguousarray(
            a[:, i] if ranked else a[i]))

    return {k: ([jax.tree.map(lambda a: layer(a, i), v)
                 for i in range(TINY["n_layers"])] if k == "blocks"
                else jax.tree.map(lambda a: torch.tensor(np.asarray(a)), v))
            for k, v in tree.items()}


def _n(tree, ranked=False):
    """The port's tree (blocks a list of layers) in the reference's
    layout, as numpy."""
    def host(t):
        return t.detach().numpy()

    return {k: (jax.tree.map(lambda *ls: np.stack(
                [host(x) for x in ls], axis=1 if ranked else 0), *v)
                if k == "blocks" else jax.tree.map(host, v))
            for k, v in tree.items()}


def _close(a, b, tol, what=""):
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                            jax.tree.leaves(b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        scale = max(1.0, np.abs(y).max())
        assert np.abs(x - y).max() <= tol * scale, \
            (what, jax.tree_util.keystr(path), np.abs(x - y).max())


def test_optimizer_matches_jax(tiny):
    """adamw_update in place (plain, with skip true / false, with
    grad_scale), cosine_lr over warmup and decay, global_grad_norm with
    replication factors: within 1e-6 of the reference on the same numpy
    trees."""
    _, _, tree, _ = tiny
    rng = np.random.default_rng(2)
    g, m = _rand_tree(tree, rng), _rand_tree(tree, rng)
    v = _rand_tree(tree, rng, positive=True)
    for skip in (None, False, True):
        for scale in (None, 0.37):
            jo = {"m": m, "v": v, "step": jnp.int32(3)}
            jp, jn = jopt.adamw_update(
                g, jo, tree, lr=jnp.float32(3e-3), grad_scale=scale,
                skip=None if skip is None else jnp.bool_(skip))
            to = {"m": _t(m), "v": _t(v),
                  "step": torch.tensor(3, dtype=torch.int32)}
            tp = _t(tree)
            out = topt.adamw_update(
                _t(g), to, tp, lr=torch.tensor(3e-3),
                grad_scale=None if scale is None else torch.tensor(scale),
                skip=None if skip is None else torch.tensor(skip))
            # in place: the same trees come back, holding the update
            assert out[0] is tp and out[1] is to
            _close(_n(tp), jp, OPT_TOL, "params")
            _close(_n(to["m"]), jn["m"], OPT_TOL, "m")
            _close(_n(to["v"]), jn["v"], OPT_TOL, "v")
            assert int(to["step"]) == int(jn["step"])
            if skip:
                _close(_n(tp), tree, 0.0, "skipped params")
    for step in (0, 1, 4, 5, 9, 12):
        want = float(jopt.cosine_lr(jnp.int32(step), base_lr=1e-2, warmup=5,
                                    total=10))
        got = float(topt.cosine_lr(torch.tensor(step, dtype=torch.int32),
                                   base_lr=1e-2, warmup=5, total=10))
        assert abs(got - want) <= OPT_TOL * 1e-2, (step, got, want)
    repl = jax.tree.map(lambda _: 3, tree)
    want = float(jopt.global_grad_norm(g, repl, ()))
    got = float(topt.global_grad_norm(_t(g), jax.tree.map(
        lambda _: 3, _t(g))))
    assert abs(got - want) <= OPT_TOL * want


def test_data_bitwise_the_reference():
    """SyntheticLMData's batches at steps 0 and 5, and after reshard(2,
    1), bitwise the reference's."""
    for kw in ({}, {"n_hosts": 2, "host_id": 0}):
        a = jdata.SyntheticLMData(97, 32, 8, seed=1, **kw)
        b = tdata.SyntheticLMData(97, 32, 8, seed=1, **kw)
        for x, y in ((a, b), (a.reshard(2, 1), b.reshard(2, 1))):
            for step in (0, 5):
                for k in ("tokens", "labels"):
                    np.testing.assert_array_equal(x.batch(step)[k],
                                                  y.batch(step)[k])


def test_attention_grad_and_xent(tiny):
    """Kernel 3 under autograd (its plain version on CPU tensors): dq, dk,
    dv against ``jax.grad`` of the reference's ``attn_core`` (GQA g = 2,
    causal, windowed, non-causal; tiles of 5 queries so the tiling shows),
    within 1e-5; ``attention_prefill`` takes the Function only under
    grad, under ``inference_mode`` the kernel's call alone.
    ``sharded_xent`` against the reference's at LOCAL, and its
    vocab-parallel form on a 2-rank mesh == tp=1."""
    TILE_ELEMS = FA.TILE_ELEMS
    rng = np.random.default_rng(3)
    Bq, Hq, Hkv, Sq, hd = 2, 4, 2, 12, 16
    q = rng.standard_normal((Bq, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, Hkv, hd)).astype(np.float32)
    w = rng.standard_normal((Bq, Sq, Hq, hd)).astype(np.float32)
    for causal, window in ((True, 0), (True, 4), (False, 0)):
        def jloss(q_, k_, v_):
            pos = jnp.arange(Sq)
            mask = JL._mask(pos, pos, causal=causal, window=window)
            return jnp.sum(JL.attn_core(q_, k_, v_, mask, Hq // Hkv) * w)
        want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        FA.TILE_ELEMS = Bq * Hq * Sq * 5
        try:
            o = FA.FlashAttention.apply(*(t.transpose(1, 2) for t in ts),
                                        causal, window)
            (o.transpose(1, 2) * torch.tensor(w)).sum().backward()
        finally:
            FA.TILE_ELEMS = TILE_ELEMS
        for t, a in zip(ts, want):
            assert np.abs(t.grad.numpy() - np.asarray(a)).max() < 1e-5
    _, tcfg, tree, _ = tiny
    attn = TT.trainable(_port_model(tcfg, tree)).blocks[0].attn
    h = torch.tensor(rng.standard_normal((1, 2, 8, 64)).astype(np.float32))
    pos = torch.arange(8, dtype=torch.int32)
    with mock.patch.object(FA.FlashAttention, "apply",
                           side_effect=FA.FlashAttention.apply) as spy:
        heads, _ = TL.attention_prefill(attn, h, tcfg, positions=pos)
        assert spy.call_count == 1 and heads.grad_fn is not None
        with torch.inference_mode():
            again, _ = TL.attention_prefill(attn, h, tcfg, positions=pos)
        assert spy.call_count == 1 and torch.equal(again, heads.detach())
    # cross-entropy: padded vocab (97 real ids of a 100-wide table) and
    # the vocab-parallel form over 2 ranks
    lg = rng.standard_normal((2, 5, 100)).astype(np.float32)
    lab = rng.integers(0, 97, (2, 5)).astype(np.int32)
    want = float(JL.sharded_xent(lg, lab, JLOCAL, 100, 97))
    got = TL.sharded_xent(torch.tensor(lg)[None], torch.tensor(lab),
                          ParallelCtx(), None, 97)
    assert abs(float(got[0]) - want) < 1e-6
    mesh = VirtualMesh(1, 2, device="cpu")
    cut = torch.stack(torch.tensor(lg).chunk(2, dim=-1))
    tp = TL.sharded_xent(cut, torch.tensor(lab), ParallelCtx(
        tp_fast=("model",)), mesh, 97)
    assert torch.allclose(tp, got.expand(2), atol=1e-6)


def _jax_step(jcfg, tree, batch, steps=3):
    mesh = make_test_mesh((1, 1), ("data", "model"))
    ctx = JCtx(tp_fast=("model",), dp=("data",), fsdp=("data",),
               ep=("model",), sp=("model",))
    jap = JT.make_plan(jcfg, 1)
    built = jax_train_step(jap, ctx, mesh, microbatches=2, **LR)
    params = jax.tree.map(jnp.asarray, tree)
    opt = jopt.adamw_init(params)
    fn = jax.jit(built.fn).lower(params, opt, batch).compile(
        compiler_options=FAST_COMPILE)
    out = []
    for _ in range(steps):
        params, opt, m = fn(params, opt, batch)
        out.append({k: float(x) for k, x in m.items()})

    def loss(p):
        lg = JT.forward_lm(p, batch["tokens"], jap, JLOCAL)[0]
        return JL.sharded_xent(lg, batch["labels"], JLOCAL, jap.vocab_pad,
                               jcfg.vocab_size)
    return out, jax.grad(loss)(jax.tree.map(jnp.asarray, tree))


def test_train_step_matches_jax(tiny):
    """R = 1 under the reference's training ctx, microbatches 2, from the
    same bridged weights: the first step's loss and grad norm within
    1e-4 relative of the reference's ``build_train_step``, the gradient
    tree within 1e-4 of ``jax.grad`` of its loss, a 3-step loss trajectory
    within 1e-3."""
    jcfg, tcfg, tree, batch = tiny
    jm, jgrad = _jax_step(jcfg, tree, batch)
    ap = TT.make_plan(tcfg, 1)
    model = _port_model(tcfg, tree)
    opt = topt.adamw_init(TT.params_tree(model))
    step = build_train_step(ap, single_pod_ctx(), None, microbatches=2,
                            **LR)
    _, grads = step.grads(model, batch)
    _close(jax.tree.map(lambda t: t[0], grads), jgrad, STEP_TOL, "grad")
    losses = []
    for i in range(3):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            for k in ("loss", "grad_norm"):
                assert abs(float(m[k]) - jm[0][k]) <= STEP_TOL * jm[0][k]
            assert float(m["skipped"]) == 0.0
    want = [x["loss"] for x in jm]
    assert np.abs(np.array(losses) - want).max() <= TRAJ_TOL * max(want)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("strategy", ["flat", "rd", "rd_int8"])
def test_data_parallel_update_matches_jax(tiny, strategy):
    """On VirtualMesh(2, 1) and (4, 1): each pod's own random gradients
    through the step's update half (``grad_cross_pod_reduce`` in pieces,
    the norm, the clip, AdamW in place, per-rank parameters and moments)
    against the reference's ``grad_cross_pod_reduce``,
    ``global_grad_norm`` and ``adamw_update`` under ``jax.vmap(
    axis_name="pod")``: the reduced gradients, the norm and every pod's
    updated parameters and moments.  flat / rd: within f32 summation
    order; rd_int8: the same int8 steps on both sides (its pods' copies
    drift apart, and do so equally on both)."""
    jcfg, tcfg, tree, _ = tiny
    tol = {"flat": 1e-6, "rd": 1e-6, "rd_int8": 1e-5}[strategy]
    jctx = JCtx(dp=("pod",), grad_reduce_strategy=strategy)
    for pods in (2, 4):
        rng = np.random.default_rng(pods)
        g = _rand_tree(tree, rng, (pods,))
        m = _rand_tree(tree, rng, (pods,))
        v = _rand_tree(tree, rng, (pods,), positive=True)
        p = jax.tree.map(lambda a: np.broadcast_to(a, (pods,) + a.shape),
                         tree)
        repl = jax.tree.map(lambda _: pods, tree)

        def jfn(g_, p_, m_, v_):
            g_ = JH.grad_cross_pod_reduce(g_, jctx, ("pod",))
            gn = jopt.global_grad_norm(g_, repl, ("pod",))
            scale = jnp.where(gn > 1.0, 1.0 / (gn + 1e-9), 1.0)
            lr = jopt.cosine_lr(jnp.int32(3), base_lr=1e-2, warmup=1,
                                total=10)
            p2, o2 = jopt.adamw_update(
                g_, {"m": m_, "v": v_, "step": jnp.int32(3)}, p_, lr=lr,
                grad_scale=scale, skip=~jnp.isfinite(gn))
            return g_, gn, p2, o2["m"], o2["v"]

        jg, jn, jp, jm, jv = jax.jit(jax.vmap(jfn, axis_name="pod")).lower(
            g, p, m, v).compile(compiler_options=NO_ALGSIMP)(g, p, m, v)
        mesh = VirtualMesh(pods, 1, device="cpu")
        ap = TT.make_plan(tcfg, 1)
        step = build_train_step(ap, ParallelCtx(
            dp=("pod",), grad_reduce_strategy=strategy), mesh, **LR)
        model = _port_model(tcfg, tree, pods)
        params = TT.params_tree(model)
        opt = {"m": _t(m, True), "v": _t(v, True),
               "step": torch.tensor(3, dtype=torch.int32)}
        grads = jax.tree.map(torch.tensor, g)
        # pieces of 256 elements: several a leaf, whole int8 groups
        from repro_torch.core import hierarchical as TH
        piece, TH.GRAD_PIECE = TH.GRAD_PIECE, 256
        try:
            met = step.update(params, opt, grads)
        finally:
            TH.GRAD_PIECE = piece
        _close(grads, jg, tol, f"{strategy} {pods} grads")
        assert abs(float(met["grad_norm"]) - float(jn[0])) \
            <= tol * float(jn[0])
        _close(_n(params, True), jp, tol, f"{strategy} {pods} params")
        _close(_n(opt["m"], True), jm, tol, f"{strategy} {pods} m")
        _close(_n(opt["v"], True), jv, tol, f"{strategy} {pods} v")
        same = all(torch.equal(t[0], t[r]) for t in
                   jax.tree.leaves(grads) for r in range(pods))
        assert same == (strategy != "rd_int8")


def test_remat_and_microbatches(tiny):
    """remat on == off and microbatches 2 against 1: the gradient trees
    within 1e-6; a 2-pod data-parallel step's grads are each pod's
    half-batch grads."""
    _, tcfg, tree, batch = tiny
    ap = TT.make_plan(tcfg, 1)
    model = _port_model(tcfg, tree)
    ref = None
    for remat, mb in ((True, 2), (False, 2), (True, 1)):
        step = build_train_step(ap, single_pod_ctx(), None,
                                microbatches=mb, remat=remat, **LR)
        _, g = step.grads(model, batch)
        g = [t[0] for t in jax.tree.leaves(g)]
        if ref is None:
            ref = g
        for a, b in zip(g, ref):
            assert (a - b).abs().max() <= 1e-6 * max(1.0, b.abs().max())
    dp = build_train_step(ap, ParallelCtx(dp=("pod",)),
                          VirtualMesh(2, 1, device="cpu"), **LR)
    _, g2 = dp.grads(_port_model(tcfg, tree, 2), batch)
    half = build_train_step(ap, single_pod_ctx(), None, **LR)
    for r in range(2):
        _, gr = half.grads(model, {k: a[r * 4:(r + 1) * 4]
                                   for k, a in batch.items()})
        for a, b in zip(jax.tree.leaves(g2), jax.tree.leaves(gr)):
            assert (a[r] - b[0]).abs().max() <= 1e-6


def test_nan_gradient_skipped():
    """An inf poked into ``wg``: skipped == 1, every parameter bitwise
    unchanged, ``opt["step"]`` not advanced."""
    cfg = get_smoke("llama3.2-1b")
    ap = TT.make_plan(cfg, 1)
    model = TT.init_params(ap, seed=0, device="cpu")
    with torch.no_grad():
        model.blocks[0].mlp["wg"][0, 0] = float("inf")
    before = [t.detach().clone() for t in model.parameters()]
    opt = topt.adamw_init(TT.params_tree(model))
    step = build_train_step(ap, single_pod_ctx(), None, base_lr=1e-2,
                            warmup=0)
    tok = np.zeros((2, 8), np.int32)
    model, opt, m = step(model, opt, {"tokens": tok, "labels": tok})
    assert float(m["skipped"]) == 1.0
    assert int(opt["step"]) == 0
    for a, b in zip(before, model.parameters()):
        assert torch.equal(a, b.detach())


def test_checkpoint_roundtrip_and_interop(tiny, tmp_path):
    """A bf16 model's train state (bf16 params, f32 moments, int32 step)
    round-trips bitwise, a stale ``.tmp`` directory is ignored and
    ``keep`` prunes; the reference's ``restore`` reads a port f32
    checkpoint into its tree, and the port's reads the reference's (f32
    and bf16)."""
    jcfg, tcfg, tree, _ = tiny
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    model = TT.init_params(TT.make_plan(cfg, 1), seed=3, device="cpu")
    opt = topt.adamw_init(TT.params_tree(model))
    rng = np.random.default_rng(4)
    for t in jax.tree.leaves(opt["m"]):
        t.copy_(torch.tensor(rng.standard_normal(t.shape)))
    opt["step"].fill_(7)
    d = str(tmp_path / "ck")
    state = train_state(model, opt)
    for s in (1, 2, 3, 4):
        tck.save(d, s, state)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert tck.latest_step(d) == 4
    assert sorted(os.listdir(d))[:3] == ["LATEST", "step_00000002",
                                         "step_00000003"]
    step, got = tck.restore(d, train_state(TT.init_params(
        TT.make_plan(cfg, 1), seed=5, device="cpu"),
        topt.adamw_init(TT.params_tree(model))))
    assert step == 4
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # port f32 -> reference
    fm = _port_model(tcfg, tree)
    tck.save(str(tmp_path / "p"), 2, {"params": stack_layers(
        TT.to_global(fm))})
    _, jt = jck.restore(str(tmp_path / "p"), {"params": jax.tree.map(
        jnp.asarray, tree)})
    _close(jt["params"], tree, 0.0, "port -> jax")
    # reference -> port, f32 and bf16
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        src = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
        jck.save(str(tmp_path / f"j{jdt.__name__}"), 5, {"params": src})
        m2 = TT.init_params(TT.make_plan(dataclasses.replace(
            tcfg, dtype=dt), 1), seed=9, device="cpu")
        _, pt = tck.restore(str(tmp_path / f"j{jdt.__name__}"),
                            {"params": stack_layers(TT.to_global(m2))})
        for a, b in zip(jax.tree.leaves(pt["params"]), jax.tree.leaves(src)):
            assert a.dtype == dt
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
    np.testing.assert_array_equal(
        params_to_numpy(fm)["blocks"]["attn"]["wq"],
        tree["blocks"]["attn"]["wq"])
    # to_global inverts from_global on a TP mesh too
    mesh = VirtualMesh(1, 2, device="cpu")
    cut = TT.from_global(TT.to_global(fm), mesh)
    for a, b in zip(cut.parameters(),
                    TT.from_global(TT.to_global(cut, mesh), mesh)
                    .parameters()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(params_to_numpy(cut, mesh)["embed"]["tok"],
                                  tree["embed"]["tok"])


def test_run_training_resume_and_preemption(tmp_path):
    """``run_training`` on the CPU (the llama smoke model, bf16): 6 steps
    straight against 3 + checkpoint + resume 3, bitwise; a SIGTERM stops
    a run with ``preempted`` and ``latest_step == stopped_at``; 2 pods
    under rd_int8 train."""
    kw = dict(global_batch=4, seq_len=16, microbatches=1, log_every=100,
              device="cpu")
    d = str(tmp_path / "ck")
    full = run_training("llama3.2-1b", steps=6, **kw)
    run_training("llama3.2-1b", steps=3, ckpt_dir=d, ckpt_every=3, **kw)
    res = run_training("llama3.2-1b", steps=6, ckpt_dir=d, **kw)
    assert res["history"][0]["step"] == 3
    assert [h["loss"] for h in full["history"][3:]] \
        == [h["loss"] for h in res["history"]]
    for a, b in zip(full["model"].parameters(), res["model"].parameters()):
        assert torch.equal(a, b)

    d2 = str(tmp_path / "pre")

    def fire():
        time.sleep(0.3)
        signal.raise_signal(signal.SIGTERM)

    t = threading.Thread(target=fire)
    t.start()
    out = run_training("llama3.2-1b", steps=10**6, ckpt_dir=d2,
                       ckpt_every=10**9, **{**kw, "log_every": 10**9})
    t.join()
    assert out["preempted"]
    assert tck.latest_step(d2) == out["stopped_at"]
    dp = run_training("llama3.2-1b", steps=3, pods=2, grad_reduce="rd_int8",
                      **kw)
    assert all(np.isfinite(h["loss"]) for h in dp["history"])


def test_refusals(tiny):
    """tp > 1, FSDP over more than one rank and every family but dense:
    NotImplementedError naming ROADMAP item 11; serving's check_layout
    still refuses dp."""
    _, tcfg, _, _ = tiny
    match = "ROADMAP item 11"
    with pytest.raises(NotImplementedError, match=match):
        build_train_step(TT.make_plan(tcfg, 2), ParallelCtx(
            tp_fast=("model",)), VirtualMesh(1, 2, device="cpu"))
    with pytest.raises(NotImplementedError, match=match):
        build_train_step(TT.make_plan(tcfg, 1), ParallelCtx(
            tp_fast=("model",)), VirtualMesh(2, 2, device="cpu"))
    with pytest.raises(NotImplementedError, match=match):
        build_train_step(TT.make_plan(tcfg, 1), ParallelCtx(
            dp=("pod",), fsdp=("pod",)), VirtualMesh(2, 1, device="cpu"))
    for arch in ("qwen3-moe-30b-a3b", "rwkv6-7b", "hymba-1.5b",
                 "whisper-medium", "pixtral-12b"):
        with pytest.raises(NotImplementedError, match=match):
            build_train_step(TT.make_plan(get_smoke(arch), 1),
                             single_pod_ctx(), None)
    with pytest.raises(NotImplementedError, match=match):
        TT.check_layout(TT.make_plan(tcfg, 1), single_pod_ctx(), None)
