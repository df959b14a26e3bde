"""Wrapper of the Hopper recursive-doubling all-reduce kernel,
``csrc/rd_allreduce.cu`` (the port of ``kernels/rd_allreduce/kernel.py
::_rd_kernel`` and its ``ops.py::rd_all_reduce_pallas``).

The operand holds the ranks of a virtual mesh on its leading axis, slow
major (rank = pod * fast + f).  ``pods == 1`` (identity) and a
non-power-of-two ``pods`` (plain sum) are the reference's own dispatch and
stay so on every device.  Otherwise a CUDA tensor launches the kernel (or
the wrapper raises) and a CPU tensor takes the plain version in ``ref.py``.

The kernel has two protocols (``csrc/rd_allreduce.cu``): LL packets (4
bytes of data and the call's epoch in one 8-byte store, the steps fused
in registers) for a per-rank message of at most ``LL_MAX_BYTES``, and
pieces with release/acquire flags above it; both give the same bits.
:func:`rd_protocol` picks one; the module attribute ``PROTOCOL`` forces
one (the card's sweep in ``chip_smoke.py`` uses it; no entry point
offers it).

The kernel's receive buffers, flags and epoch persist across calls in an
:class:`RDWorkspace`, which the mesh owns (the port's analogue of
NVSHMEM's symmetric heap): it grows to the largest message and is reused
by every later call on the same stream, and the kernel allocates nothing.
The fused GEMM + recursive-doubling kernel
(:mod:`repro_torch.kernels.fused_matmul_rd`) keeps its own buffers and
flags in the same workspace.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import _build
from .._checks import DTYPES
from .ref import is_pow2, rd_all_reduce_ref, slow_sum

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 5 + (ctypes.c_longlong,) + (_I,) * 7 + (_P,)
_LL_ARGTYPES = (_P,) * 4 + (ctypes.c_longlong,) + (_I,) * 6 + (_P,)
THREADS = 256            # kThreads in csrc/rd_allreduce.cu
UNITS_PER_THREAD = 2     # 16-byte vectors per thread a piece aims for
# LL packets a thread a round (a template parameter of the kernel): the
# fewest of these that cover a rank's packets in one round of resident
# CTAs (one at 16 and 128 KB a rank on 4 x 2 ranks, the fastest there).
LL_PPT = (1, 2, 4)
LL_PAYLOAD = 4           # data bytes of an 8-byte LL packet
# Per-rank message bytes up to which the LL protocol runs: the sweep of
# both protocols at chip_smoke.py's RD_SIZES on an H100 (bf16, 4 x 2
# ranks) has LL ahead at 16 KB and 128 KB and the flags ahead from 512 KB
# (PERF.md).
LL_MAX_BYTES = 128 * 2**10
# None: pick the protocol by message size; "ll" or "simple" forces one.
PROTOCOL = None
# Epoch words a device (kEpochWords in csrc/exchange_common.cuh).
EPOCH_WORDS = 8


def rd_pieces(m_units: int, n_ranks: int, n_chunks: int,
              max_ctas: int) -> int:
    """CTAs per chunk of one rank's row for the flag protocol: enough
    that each thread moves about ``UNITS_PER_THREAD`` vectors, no more
    than keep the whole grid (n_ranks x n_chunks x the result) resident
    on the card at once."""
    cap = max_ctas // (n_ranks * n_chunks)
    if cap < 1:
        raise ValueError(
            f"rd_all_reduce: {n_ranks} ranks x {n_chunks} chunks need more "
            f"CTAs than the {max_ctas} the card holds resident at once")
    per_chunk = -(-m_units // n_chunks)
    return min(cap, max(1, -(-per_chunk // (THREADS * UNITS_PER_THREAD))))


def rd_protocol(nbytes: int) -> str:
    """The protocol for a per-rank message of ``nbytes``: "ll" up to
    ``LL_MAX_BYTES``, "simple" (pieces and flags) above, unless
    ``PROTOCOL`` forces one."""
    if PROTOCOL is not None:
        if PROTOCOL not in ("ll", "simple"):
            raise ValueError(f"rd_all_reduce: PROTOCOL={PROTOCOL!r}")
        return PROTOCOL
    return "ll" if nbytes <= LL_MAX_BYTES else "simple"


def ll_packets(m: int, esz: int) -> int:
    """8-byte packets of a row of m elements: ``LL_PAYLOAD`` data bytes
    each, the last one padded."""
    return -(-m * esz // LL_PAYLOAD)


def ll_recv_bytes(steps: int, n_ranks: int, m: int, esz: int) -> int:
    """The LL receive buffers, (steps, R, packets) of 8 bytes: twice the
    payload, one buffer a step."""
    return steps * n_ranks * ll_packets(m, esz) * 8


def ll_plan(n_packets: int, n_ranks: int, max_ctas: int) -> Tuple[int, int]:
    """(CTAs a rank, packets a thread a round) of the LL kernel: the
    fewest packets a thread in ``LL_PPT`` that cover a rank's packets in
    one round of the CTAs the card holds resident, else the most, and as
    many CTAs as stay resident (a CTA then walks its range in rounds)."""
    cap = max_ctas // n_ranks
    if cap < 1:
        raise ValueError(
            f"rd_all_reduce: {n_ranks} ranks need more CTAs than the "
            f"{max_ctas} the card holds resident at once")
    for ppt in LL_PPT:
        pieces = -(-n_packets // (THREADS * ppt))
        if pieces <= cap:
            return max(1, pieces), ppt
    return cap, ppt


class RDWorkspace:
    """Receive buffers, flags and epoch words of the exchange kernels, per
    device and per kernel (``kernel`` names it: "rd" for this kernel's
    (steps, R, m) buffers and (steps, R, stride) flags, "fused_matmul_rd"
    for the fused kernel's), and this kernel's LL packet buffers.

    Both kernels take their flag value from epochs in device memory
    (:meth:`control`: ``EPOCH_WORDS`` 64-bit words a device, 128 bytes
    apart, each int32 [ticket, epoch]): each CTA reads its word's epoch and
    counts itself in one atomic add and the CTA that completes the word's
    count moves it on, so a captured CUDA graph replays correctly.  This
    kernel gives the CTAs of every ``EPOCH_WORDS``-th piece one word; the
    fused kernel counts its whole grid on word 0 of its own words.  The
    two kernels' flags and epoch words are separate arrays, so their
    numbers never satisfy each other's waits.  An epoch only grows
    (skipping 0), flags and packets start at zero and only ever hold a
    call's number, so they are never reset; a buffer grows (zeroed anew)
    when a call needs more, and is never shrunk or reallocated per call.

    A captured CUDA graph keeps the addresses of the buffers its calls
    took.  So no buffer grows while a graph is captured (the capture
    raises: warm up at the captured shapes first), and a buffer that a
    capture took and a later eager call (a longer prompt's prefill) grows
    moves :attr:`generation` on: :class:`~repro_torch.parallel.steps.
    CapturedStep` captures its step anew before it would replay a graph
    of an older generation."""

    def __init__(self):
        self._recv: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        self._flags: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        self._ctl: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        # (store, key) of the buffers a capture took since the last move
        self._held: set = set()
        self.generation = 0

    @staticmethod
    def _capturing(device: torch.device, refuse: str = "") -> bool:
        """Whether a CUDA graph is being captured on ``device``'s stream;
        with ``refuse`` (what would be allocated), raise if so."""
        capturing = device.type == "cuda" \
            and torch.cuda.is_current_stream_capturing()
        if capturing and refuse:
            raise RuntimeError(
                f"RDWorkspace: {refuse} would be allocated while a CUDA "
                "graph is captured; run the captured step once first")
        return capturing

    def _get(self, store: str, key: Tuple[str, torch.device], n: int,
             make, what: str) -> torch.Tensor:
        """The buffer ``key`` of ``store`` with at least ``n`` elements,
        made by ``make(n)`` if it is missing or smaller."""
        d = getattr(self, store)
        t = d.get(key)
        if t is None or t.numel() < n:
            self._capturing(key[1], refuse=what)
            if (store, key) in self._held:
                self._held.clear()
                self.generation += 1
            t = d[key] = make(n)
        elif self._capturing(key[1]):
            self._held.add((store, key))
        return t

    def buffers(self, device: torch.device, recv_bytes: int, n_flags: int,
                kernel: str = "rd") -> Tuple[torch.Tensor, torch.Tensor]:
        key = (kernel, device)
        recv = self._get("_recv", key, recv_bytes, lambda n: torch.empty(
            n, dtype=torch.uint8, device=device), f"{kernel}'s receive buffer")
        flags = self._get("_flags", key, n_flags, lambda n: torch.zeros(
            n, dtype=torch.int32, device=device), f"{kernel}'s flags")
        return recv, flags

    def ll_buffer(self, device: torch.device, nbytes: int) -> torch.Tensor:
        """This kernel's LL packets, zero at first use (no epoch is 0)."""
        return self._get("_recv", ("rd_ll", device), nbytes,
                         lambda n: torch.zeros(n, dtype=torch.uint8,
                                               device=device),
                         "the LL buffer")

    def control(self, device: torch.device, kernel: str = "rd"
                ) -> torch.Tensor:
        """``kernel``'s epoch words on ``device``: int32 (EPOCH_WORDS,
        32), row k's [ticket, epoch] read by the kernel as the 64-bit word
        (epoch << 32) | ticket, each epoch starting at 1."""
        key = (kernel, device)
        ctl = self._ctl.get(key)
        if ctl is None:
            self._capturing(device, refuse=f"{kernel}'s epoch words")
            ctl = torch.zeros((EPOCH_WORDS, 32), dtype=torch.int32,
                              device=device)
            ctl[:, 1] = 1
            self._ctl[key] = ctl
        return ctl

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for d in (self._recv, self._flags, self._ctl)
                   for t in d.values())


_max_ctas: Dict[Tuple, int] = {}


def _resident_ctas(device: torch.device, is_bf16: int, vec: int,
                   ll: int = 0) -> int:
    key = (device, is_bf16, vec, ll)
    if key not in _max_ctas:
        fn = _build.c_function("rd_allreduce", "rd_allreduce_max_ctas",
                               (_I, _I, _I))
        with torch.cuda.device(device):
            n = fn(is_bf16, vec, ll)
        if n < 0:
            _build.check("rd_allreduce", "rd_allreduce_max_ctas", -n)
        if n == 0:
            raise RuntimeError("rd_all_reduce: no CTA of the kernel fits "
                               "on an SM")
        _max_ctas[key] = n
    return _max_ctas[key]


def rd_all_reduce(x: torch.Tensor, pods: int, *, n_chunks: int = 1,
                  workspace: RDWorkspace | None = None) -> torch.Tensor:
    """x (R, ...), R = pods * fast ranks slow-major -> the sum over the
    slow axis on every rank, in x's shape and type.

    log2(pods) XOR-peer steps in one launch; ``n_chunks`` pieces per rank
    are exchanged independently (each split further over CTAs) by the
    flag protocol, and the LL protocol's packets are independent whatever
    it is: it never changes the result.  ``workspace`` (the mesh's) is
    required on CUDA."""
    R = x.shape[0]
    if pods < 1 or R % pods:
        raise ValueError(f"rd_all_reduce: {R} ranks are not pods={pods} "
                         "times a fast axis")
    if n_chunks < 1:
        raise ValueError(f"rd_all_reduce: n_chunks={n_chunks} must be >= 1")
    if pods == 1:
        return x
    if not is_pow2(pods):
        return slow_sum(x, pods)
    if x.device.type == "cpu":
        return rd_all_reduce_ref(x, pods, n_chunks=n_chunks)
    if x.device.type != "cuda" or x.dtype not in DTYPES:
        raise ValueError(f"rd_all_reduce: expected a CUDA tensor of "
                         f"{DTYPES}, got {x.dtype} on {x.device}")
    if workspace is None:
        raise ValueError("rd_all_reduce: a CUDA call needs the mesh's "
                         "RDWorkspace")
    xc = x.contiguous()
    m = xc[0].numel()
    esz = xc.element_size()
    is_bf16 = int(x.dtype == torch.bfloat16)
    steps = pods.bit_length() - 1
    ctl = workspace.control(x.device)
    out = torch.empty_like(xc)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if rd_protocol(m * esz) == "ll":
        word = int((m * esz) % LL_PAYLOAD == 0
                   and xc.data_ptr() % LL_PAYLOAD == 0)
        pieces, ppt = ll_plan(ll_packets(m, esz), R,
                              _resident_ctas(x.device, is_bf16, word, ll=1))
        recv = workspace.ll_buffer(x.device, ll_recv_bytes(steps, R, m, esz))
        fn = _build.c_function("rd_allreduce", "rd_allreduce_ll_launch",
                               _LL_ARGTYPES)
        err = fn(xc.data_ptr(), out.data_ptr(), recv.data_ptr(),
                 ctl.data_ptr(), m, R, pods, pieces, is_bf16, word, ppt,
                 stream)
    else:
        vec = int((m * esz) % 16 == 0 and xc.data_ptr() % 16 == 0)
        units = m // (16 // esz) if vec else m
        max_ctas = _resident_ctas(x.device, is_bf16, vec)
        per_chunk = rd_pieces(units, R, n_chunks, max_ctas)
        recv, flags = workspace.buffers(x.device, steps * R * m * esz,
                                        steps * R * max_ctas)
        fn = _build.c_function("rd_allreduce", "rd_allreduce_launch",
                               _ARGTYPES)
        err = fn(xc.data_ptr(), out.data_ptr(), recv.data_ptr(),
                 flags.data_ptr(), ctl.data_ptr(), m, R, pods, n_chunks,
                 per_chunk, max_ctas, is_bf16, vec, stream)
    _build.check("rd_allreduce", "rd_all_reduce", err)
    rd_all_reduce.launches += 1
    return out.view(x.shape)


rd_all_reduce.launches = 0

__all__ = ["rd_all_reduce", "rd_all_reduce_ref", "RDWorkspace", "rd_pieces",
           "rd_protocol", "ll_packets", "ll_recv_bytes", "ll_plan",
           "LL_MAX_BYTES"]
