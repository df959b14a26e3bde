"""The port's NVRAR cost model (``repro_torch/core/comm_model.py``) and
cluster simulator (``repro_torch/inference/simulator.py``) held bitwise
against the JAX package's on grids of sizes, node counts, networks,
models, schemes and all-reduce algorithms; the reference's seven
simulator observations (``tests/test_simulator.py``) run on the port; and
the port's own chip, ``H100``, checked field by field."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import llama3_paper as JP  # noqa: E402
from repro.core import comm_model as JCM  # noqa: E402
from repro.inference import simulator as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import llama3_paper as TP  # noqa: E402
from repro_torch.core import comm_model as TCM  # noqa: E402
from repro_torch.inference import simulator as TS  # noqa: E402

SIZES = [2**k for k in range(10, 25, 2)]          # 1 KB .. 16 MB
NODES = [1, 2, 3, 4, 8, 16, 64]
NETS = ("perlmutter", "vista", "tpu_v5e")
ALGOS = ("nccl", "ring", "tree", "nvrar", "nvrar_halving")
# (port config, reference config): the paper's two models and the main
# path's.
MODELS = [(TP.LLAMA31_70B, JP.LLAMA31_70B), (TP.LLAMA31_405B, JP.LLAMA31_405B),
          (get_config("llama3.2-1b"), jax_config("llama3.2-1b"))]


def test_nvrar_cost_model_equals_the_jax_package():
    assert TCM.__all__ == JCM.__all__
    for name in NETS:
        tn, jn = TCM.NETWORKS[name], JCM.NETWORKS[name]
        assert dataclasses.asdict(tn) == dataclasses.asdict(jn)
        for m in SIZES:
            assert TCM.decode_allreduce_bytes(m, 8192) \
                == JCM.decode_allreduce_bytes(m, 8192)
            for n in NODES:
                for g in (1, 4, tn.gpus_per_node):
                    for eta in (1.0, 1.03, 2.0):
                        for f in ("t_rd_inter", "t_nvrar", "nvrar_speedup"):
                            assert getattr(TCM, f)(m, n, g, tn, eta=eta) \
                                == getattr(JCM, f)(m, n, g, jn, eta=eta)
                        for inter in ("paper", "full_exchange", "halving"):
                            assert TCM.t_nvrar_variant(
                                m, n, g, tn, inter=inter, eta=eta) \
                                == JCM.t_nvrar_variant(
                                    m, n, g, jn, inter=inter, eta=eta)
        gpus = [1, 2, 4, 8, 16, 64, 256]
        assert TCM.speedup_table(tn, SIZES, gpus) \
            == JCM.speedup_table(jn, SIZES, gpus)


def _fields(bd):
    return (bd.matmul, bd.other, bd.comm, bd.idle, bd.total)


@pytest.mark.parametrize("i", range(len(MODELS)),
                         ids=[m[0].name for m in MODELS])
def test_cluster_sim_equals_the_jax_package(i):
    """``_step_time`` (both phases, with and without the all-reduce),
    ``prefill_time`` and ``decode_step_time`` under TP and HP, every
    all-reduce algorithm, on every network's chip, bitwise."""
    tcfg, jcfg = MODELS[i]
    for name in NETS:
        tn, jn = TCM.NETWORKS[name], JCM.NETWORKS[name]
        tchip, jchip = TS.CHIP_FOR_NET[name], JS.CHIP_FOR_NET[name]
        assert dataclasses.asdict(tchip) == dataclasses.asdict(jchip)
        for gpus in (1, 4, 8, 32):
            for scheme in ("tp", "hp"):
                for algo in ALGOS:
                    kw = dict(scheme=scheme, ar_algo=algo,
                              straggler_delay=2e-5 if gpus == 8 else 0.0)
                    t = TS.ClusterSim(tcfg, tchip, tn, gpus, **kw)
                    j = JS.ClusterSim(jcfg, jchip, jn, gpus, **kw)
                    for m, ctx, phase in ((8, 512, "decode"),
                                          (4096, 1426, "prefill")):
                        for ar in (True, False):
                            assert _fields(t._step_time(
                                m, ctx, phase=phase, layers=3, with_ar=ar)) \
                                == _fields(j._step_time(
                                    m, ctx, phase=phase, layers=3,
                                    with_ar=ar))
                    for b, s in ((1, 128), (8, 512), (32, 2363)):
                        assert _fields(t.prefill_time(b, s)) \
                            == _fields(j.prefill_time(b, s))
                        assert _fields(t.decode_step_time(b, s)) \
                            == _fields(j.decode_step_time(b, s))


def _trace(seed, n):
    rng = np.random.default_rng(seed)
    li = np.maximum(2, rng.lognormal(np.log(600), 0.6, n)).astype(int)
    lo = np.maximum(1, rng.lognormal(np.log(250), 0.6, n)).astype(int)
    return np.cumsum(rng.gamma(0.5, 0.2, n)), li, lo


def test_batch_latency_and_trace_equal_the_jax_package():
    (t70, j70), (t1b, j1b) = MODELS[0], MODELS[2]
    for tcfg, jcfg, gpus in ((t70, j70, 16), (t1b, j1b, 8)):
        for scheme, algo in (("tp", "nccl"), ("tp", "nvrar"),
                             ("hp", "ring")):
            kw = dict(scheme=scheme, ar_algo=algo, prompt_len=1426,
                      decode_len=64, n_prompts=8, straggler_delay=1e-5)
            tt, tb = TS.simulate_batch_latency(tcfg, TS.A100,
                                               TCM.PERLMUTTER, gpus, **kw)
            jt, jb = JS.simulate_batch_latency(jcfg, JS.A100,
                                               JCM.PERLMUTTER, gpus, **kw)
            assert tt == jt and _fields(tb) == _fields(jb)
            arr, li, lo = _trace(3, 60)
            kw = dict(scheme=scheme, ar_algo=algo, arrivals=arr, in_lens=li,
                      out_lens=lo, concurrency=16)
            assert TS.simulate_trace(tcfg, TS.A100, TCM.PERLMUTTER, gpus,
                                     **kw) \
                == JS.simulate_trace(jcfg, JS.A100, JCM.PERLMUTTER, gpus,
                                     **kw)


# ---------------------------------------------------------------------------
# The reference's observations (tests/test_simulator.py:20-71) on the port
# ---------------------------------------------------------------------------

M70, M405 = TP.LLAMA31_70B, TP.LLAMA31_405B


def _lat(model, n, scheme, algo, pl, dl, npr=8, **kw):
    t, _ = TS.simulate_batch_latency(model, TS.A100, TCM.PERLMUTTER, n,
                                     scheme=scheme, ar_algo=algo,
                                     prompt_len=pl, decode_len=dl,
                                     n_prompts=npr, **kw)
    return t


def _obs1_tp_does_not_strong_scale():
    lat = [_lat(M70, n, "tp", "nccl", 1426, 3072) for n in (8, 16, 32)]
    assert max(lat) / min(lat) < 1.15
    assert _lat(M70, 4, "tp", "nccl", 1426, 3072) > lat[0]


def _obs1_hp_wins_prefill_tp_wins_decode():
    assert _lat(M70, 32, "hp", "nccl", 2363, 128, npr=32) < \
        _lat(M70, 32, "tp", "nccl", 2363, 128, npr=32)
    assert _lat(M70, 16, "tp", "nccl", 1426, 3072) < \
        0.6 * _lat(M70, 16, "hp", "nccl", 1426, 3072)


def _obs2_decode_gemm_tile_floor():
    sim = TS.ClusterSim(M70, TS.A100, TCM.PERLMUTTER, 8, scheme="tp")
    t32 = sim._step_time(32, 1426, phase="decode", layers=1, with_ar=False)
    t16 = sim._step_time(16, 1426, phase="decode", layers=1, with_ar=False)
    assert abs(t32.matmul - t16.matmul) / t32.matmul < 1e-6
    t4096 = sim._step_time(4096, 1426, phase="prefill", layers=1,
                           with_ar=False)
    t2048 = sim._step_time(2048, 1426, phase="prefill", layers=1,
                           with_ar=False)
    assert t2048.matmul < 0.6 * t4096.matmul


def _nvrar_band_70b_405b():
    for model, gpus, lo, hi in ((M70, 32, 1.2, 2.2), (M405, 64, 1.3, 2.2)):
        s = _lat(model, gpus, "tp", "nccl", 1426, 3072, npr=32) / \
            _lat(model, gpus, "tp", "nvrar", 1426, 3072, npr=32)
        assert lo < s < hi, (model.name, s)


def _nvrar_single_node_no_gain():
    s = _lat(M70, 4, "tp", "nccl", 1426, 3072) / \
        _lat(M70, 4, "tp", "nvrar", 1426, 3072)
    assert 0.85 < s <= 1.0


def _straggler_ring_pays_more():
    base_r = _lat(M70, 16, "tp", "ring", 1426, 3072)
    slow_r = _lat(M70, 16, "tp", "ring", 1426, 3072, straggler_delay=2e-5)
    base_n = _lat(M70, 16, "tp", "nvrar", 1426, 3072)
    slow_n = _lat(M70, 16, "tp", "nvrar", 1426, 3072, straggler_delay=2e-5)
    assert slow_r > base_r and slow_n > base_n


def _trace_throughput_ordering():
    arr, li, lo = _trace(0, 200)
    out = {algo: TS.simulate_trace(M70, TS.A100, TCM.PERLMUTTER, 16,
                                   scheme="tp", ar_algo=algo, arrivals=arr,
                                   in_lens=li, out_lens=lo,
                                   concurrency=32)["throughput_tok_s"]
           for algo in ("nccl", "nvrar")}
    assert out["nvrar"] > out["nccl"]


OBSERVATIONS = {f.__name__[1:]: f for f in (
    _obs1_tp_does_not_strong_scale, _obs1_hp_wins_prefill_tp_wins_decode,
    _obs2_decode_gemm_tile_floor, _nvrar_band_70b_405b,
    _nvrar_single_node_no_gain, _straggler_ring_pays_more,
    _trace_throughput_ordering)}


@pytest.mark.parametrize("name", OBSERVATIONS)
def test_reference_observations_hold_on_the_port(name):
    OBSERVATIONS[name]()


def test_h100_is_the_measured_card():
    """The port's chip: the data-sheet peaks that chip_smoke.py's bounds
    use, and the memory and sustained bf16 share that chip_smoke.py phase
    34 measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md); no network maps
    to it (one card has none)."""
    h = TS.H100
    assert (h.name, h.flops_bf16, h.hbm_bw, h.gemm_tile_m) \
        == ("H100-80G", 989e12, 3.35e12, 128)
    assert (h.hbm_cap, h.efficiency) == (85017493504, 0.7877)
    assert h not in TS.CHIP_FOR_NET.values()
    for name in ("A100", "GH200", "V5E"):
        assert dataclasses.asdict(getattr(TS, name)) \
            == dataclasses.asdict(getattr(JS, name))
