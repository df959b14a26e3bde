"""Plain PyTorch versions of the decode-attention kernels: the port of
``repro/kernels/decode_attention/ref.py`` (what a CPU tensor runs), and the
kernels' split form (per-split partials, then their ordered merge), which
the tests hold against it."""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1.0e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor, *,
                         window: int = 0) -> torch.Tensor:
    """q: (B, Hq, hd); k/v: (B, S, Hkv, hd); positions: (B,)."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, hd).float()
    s = torch.einsum("bugh,bsuh->bugs", qg, k.float()) * (hd ** -0.5)
    kp = torch.arange(S, device=q.device)[None, :]
    pos = positions.long()[:, None]
    mask = kp <= pos
    if window > 0:
        mask &= kp > pos - window
    s = torch.where(mask[:, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bugs,bsuh->bugh", p, v.float())
    return o.reshape(B, Hq, hd).to(q.dtype)


def dequant_kv(t: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """An int8 cache (..., hd) with its bf16 scales (...) as ``dtype``:
    ``dtype(float(t) * float(scale))``, the reference's ``attn_core``."""
    return (t.float() * scale.float()[..., None]).to(dtype)


def decode_attention_int8_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, positions: torch.Tensor,
                              *, window: int = 0) -> torch.Tensor:
    """The int8 form: k/v (B, S, Hkv, hd) int8 and their (B, S, Hkv)
    bf16 scales dequantized to q's type, then :func:`decode_attention_ref`."""
    return decode_attention_ref(q, dequant_kv(k, k_scale, q.dtype),
                                dequant_kv(v, v_scale, q.dtype), positions,
                                window=window)


def paged_decode_attention_ref(q: torch.Tensor, k_phys: torch.Tensor,
                               v_phys: torch.Tensor, block_tbl: torch.Tensor,
                               positions: torch.Tensor, *,
                               window: int = 0) -> torch.Tensor:
    """Gather the logical K/V view through the block table, then run the
    dense version.  k_phys/v_phys: (n_blocks, bs, Hkv, hd);
    block_tbl: (B, max_blocks) int32."""
    B = q.shape[0]
    mb, bs = block_tbl.shape[1], k_phys.shape[1]
    Hkv, hd = k_phys.shape[2], k_phys.shape[3]
    tbl = block_tbl.long()
    k = k_phys[tbl].reshape(B, mb * bs, Hkv, hd)
    v = v_phys[tbl].reshape(B, mb * bs, Hkv, hd)
    return decode_attention_ref(q, k, v, positions, window=window)


def visible_keys(pos: int, n_keys: int, window: int) -> Tuple[int, int]:
    """(first, last) key a row with last position ``pos`` sees in a cache
    of ``n_keys``; empty when last < first (pos < 0)."""
    last = min(pos, n_keys - 1)
    return (max(0, last - window + 1) if window > 0 else 0), last


def live_splits(pos: int, n_keys: int, window: int, split: int) -> range:
    """The splits (``split`` keys each, from key 0) that hold a key the
    row sees, ascending: the CTAs that run for it and the partials its
    merge reads."""
    first, last = visible_keys(pos, n_keys, window)
    return range(first // split, last // split + 1) if last >= first \
        else range(0)


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, positions: torch.Tensor, *,
                               window: int = 0,
                               split: int = 128) -> torch.Tensor:
    """The kernel's split form in plain PyTorch, for the tests: per split
    of ``split`` keys (:func:`live_splits`), the online-softmax partial
    (m, l, acc) of each query head over the keys the row sees; then the
    partials merged in ascending split order, out = acc / max(l, 1e-30).
    A row that sees no key gets zeros.  Shapes as
    :func:`decode_attention_ref`."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
    out = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    for b in range(B):
        pos = int(positions[b])
        first, last = visible_keys(pos, S, window)
        parts = []
        for j in live_splits(pos, S, window, split):
            lo, hi = max(j * split, first), min(j * split + split - 1, last)
            s = torch.einsum("ugh,puh->ugp", qg[b],
                             k[b, lo:hi + 1].float()) * (hd ** -0.5)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum(
                "ugp,puh->ugh", p, v[b, lo:hi + 1].float())))
        if not parts:
            continue
        m = torch.stack([x[0] for x in parts]).amax(0)
        l_sum = torch.zeros_like(m)
        acc = torch.zeros_like(out[b])
        for m_j, l_j, acc_j in parts:          # ascending split order
            w = torch.exp(m_j - m)
            l_sum = l_sum + l_j * w
            acc = acc + acc_j * w[..., None]
        out[b] = acc / l_sum.clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, hd).to(q.dtype)


def paged_decode_attention_split_ref(q: torch.Tensor, k_phys: torch.Tensor,
                                     v_phys: torch.Tensor,
                                     block_tbl: torch.Tensor,
                                     positions: torch.Tensor, *,
                                     window: int = 0,
                                     split: int = 128) -> torch.Tensor:
    """The paged kernel's split form: the logical view gathered through
    the block table, then :func:`decode_attention_split_ref`."""
    B = q.shape[0]
    mb, bs = block_tbl.shape[1], k_phys.shape[1]
    Hkv, hd = k_phys.shape[2], k_phys.shape[3]
    tbl = block_tbl.long()
    k = k_phys[tbl].reshape(B, mb * bs, Hkv, hd)
    v = v_phys[tbl].reshape(B, mb * bs, Hkv, hd)
    return decode_attention_split_ref(q, k, v, positions, window=window,
                                      split=split)


__all__ = ["decode_attention_ref", "paged_decode_attention_ref",
           "decode_attention_int8_ref", "dequant_kv",
           "decode_attention_split_ref", "paged_decode_attention_split_ref",
           "live_splits", "visible_keys"]
