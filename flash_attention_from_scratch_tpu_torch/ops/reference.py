"""Plain PyTorch reference attention: the numerics oracle.

Counterpart of ``flash_attention_from_scratch_tpu/ops/reference.py``. It is
computed twice, once in the native 16-bit dtype and once upcast to fp32, to
drive the adaptive tolerance rule (``utils/testing.py``). It is also the
plain version of the flash forward kernel (``ops/flash_forward.py``).
:func:`block_flash_attention` is the block-by-block oracle: the online
softmax recurrence tile by tile, with every intermediate on request.
"""

from __future__ import annotations

import math

import torch

__all__ = ["reference_attention", "reference_pair", "block_flash_attention",
           "MASK_VALUE"]

# Finite mask value, not -inf, as in the JAX oracle and the kernels: a fully
# masked row then softmaxes to a finite (uniform) row instead of NaN.
MASK_VALUE = -1e30


def _scores(q, k, *, causal, scale, q_offset, window, softcap):
    """Scaled, softcapped, masked fp32 scores (batch, heads, sq, skv)."""
    if k.shape[1] != q.shape[1]:  # GQA: broadcast KV heads to Q heads
        k = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    # Products of 16-bit values are exact in fp32, so upcasting first is the
    # torch form of the JAX oracle's preferred_element_type=float32; fp64
    # inputs stay fp64 (the exact answer that fp32 kernels are held to).
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        # q_offset None: bottom-right alignment (row i sees kv up to
        # k_len - q_len + i); an explicit offset: row i sees [0, q_offset+i].
        q_len, k_len = s.shape[-2], s.shape[-1]
        diag = k_len - q_len if q_offset is None else q_offset
        ones = torch.ones((q_len, k_len), dtype=torch.bool, device=s.device)
        mask = torch.tril(ones, diagonal=diag)
        if window:
            # Sliding window: q position p sees kv (p - window, p].
            mask &= ~torch.tril(ones, diagonal=diag - window)
        s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    return s


def _sink_column(s, sinks):
    return sinks.to(s.dtype).reshape(1, -1, 1, 1).expand(*s.shape[:-1], 1)


def reference_attention(q, k, v, *, causal: bool = False, scale_override=None,
                        q_offset: int | None = None, window: int = 0,
                        softcap: float = 0.0, sinks=None, return_lse=False):
    """softmax(QK^T * scale) V with the softmax in fp32 (fp64 for fp64
    inputs).

    Shapes: q (batch, heads, sq, d), k/v (batch, kv_heads, skv, d). P is cast
    to the input dtype before PV, like the kernels. ``sinks`` ((heads,)
    fp32): one logit per head that joins the softmax denominator and
    carries no value. With ``return_lse`` also returns the natural-log
    log-sum-exp of each row's scaled scores (sink included), fp32
    (batch, heads, sq).
    """
    d = q.shape[-1]
    scale = scale_override if scale_override is not None else 1.0 / math.sqrt(d)
    s = _scores(q, k, causal=causal, scale=scale, q_offset=q_offset,
                window=window, softcap=softcap)
    full = s if sinks is None else torch.cat([s, _sink_column(s, sinks)], -1)
    p = torch.softmax(full, dim=-1)[..., :s.shape[-1]].to(q.dtype)
    if v.shape[1] != q.shape[1]:
        v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    out = torch.matmul(p.to(s.dtype), v.to(s.dtype)).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(full, dim=-1)
    return out


def reference_pair(q, k, v, *, causal: bool = False, q_offset=None,
                   window: int = 0, softcap: float = 0.0, sinks=None):
    """(native-dtype output, fp32 output) for the adaptive tolerance rule."""
    kw = dict(causal=causal, q_offset=q_offset, window=window,
              softcap=softcap, sinks=sinks)
    return (reference_attention(q, k, v, **kw),
            reference_attention(q.float(), k.float(), v.float(), **kw))


def block_flash_attention(q, k, v, *, block_q: int = 128, block_kv: int = 128,
                          use_exp2: bool = True, reverse_kv: bool = False,
                          collect_trace: bool = False):
    """The online-softmax recurrence block by block in plain torch, fp32
    statistics (non-causal, one scale 1 / sqrt(d)), as the JAX package's
    ``block_flash_attention``: for each (Q block, KV block) pair S, the
    running max m, the running sum l, P and the partial O. With
    ``collect_trace`` returns (output, trace), the trace one dict
    (``q_block``, ``kv_block``, ``S``, ``m``, ``l``, ``P``, ``O``) a pair in
    visiting order (KV blocks last to first with ``reverse_kv``). A
    debugging oracle: Python loops, any device. seq_q and seq_kv must be
    multiples of the blocks (``ValueError``)."""
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    if s_q % block_q or s_kv % block_kv:
        raise ValueError(
            f"seq ({s_q}, {s_kv}) not divisible by blocks ({block_q}, {block_kv}): "
            "the mirror would silently drop rows")
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((b, h, s_q, d), dtype=torch.float32, device=q.device)
    trace = []
    n_kv = s_kv // block_kv
    kv_order = range(n_kv - 1, -1, -1) if reverse_kv else range(n_kv)
    for qi in range(s_q // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        m = torch.full((b, h, block_q, 1), -math.inf, device=q.device)
        l = torch.zeros((b, h, block_q, 1), device=q.device)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for ki in kv_order:
            cols = slice(ki * block_kv, (ki + 1) * block_kv)
            s_blk = qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)
            exp = torch.exp2 if use_exp2 else torch.exp
            s_blk = s_blk * (scale * math.log2(math.e) if use_exp2 else scale)
            m_new = torch.maximum(m, s_blk.amax(-1, keepdim=True))
            p = exp(s_blk - m_new)
            alpha = exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, cols]
            m = m_new
            if collect_trace:
                trace.append(dict(q_block=qi, kv_block=ki, S=s_blk, m=m, l=l, P=p, O=acc))
        out[:, :, rows] = acc / l
    result = out.to(q.dtype)
    return (result, trace) if collect_trace else result
