"""Plain PyTorch reference attention: the numerics oracle.

Counterpart of ``flash_attention_from_scratch_tpu/ops/reference.py``. It is
computed twice, once in the native 16-bit dtype and once upcast to fp32, to
drive the adaptive tolerance rule (``utils/testing.py``). It is also the
plain version of the flash forward kernel (``ops/flash_forward.py``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["reference_attention", "reference_pair", "MASK_VALUE"]

# Finite mask value, not -inf, as in the JAX oracle and the kernels: a fully
# masked row then softmaxes to a finite (uniform) row instead of NaN.
MASK_VALUE = -1e30


def _scores(q, k, *, causal, scale, q_offset, window, softcap):
    """Scaled, softcapped, masked fp32 scores (batch, heads, sq, skv)."""
    if k.shape[1] != q.shape[1]:  # GQA: broadcast KV heads to Q heads
        k = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    # Products of 16-bit values are exact in fp32, so upcasting first is the
    # torch form of the JAX oracle's preferred_element_type=float32.
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
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
    return sinks.float().reshape(1, -1, 1, 1).expand(*s.shape[:-1], 1)


def reference_attention(q, k, v, *, causal: bool = False, scale_override=None,
                        q_offset: int | None = None, window: int = 0,
                        softcap: float = 0.0, sinks=None, return_lse=False):
    """softmax(QK^T * scale) V with the softmax in fp32.

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
    out = torch.matmul(p.float(), v.float()).to(q.dtype)
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
