"""Attention: the exact single-device op and the online-softmax blocks.

The counterpart of `sparknet_tpu/ops/attention.py`. Shapes are [B, L, H, D]
(length-major), as there. `attention` is the exact op the sequence-parallel
forms of `parallel/ring_attention.py` are held to; `block_accumulate`,
`init_accumulator` and `finalize_accumulator` are the stable online softmax
(running max and denominator) the ring pass folds its KV blocks into.

The precision policy's rounding points are the JAX package's:
  - the scores product of the two `cast_in` operands keeps the compute
    dtype (bfloat16 under "bfloat16"); the division by sqrt(d) then runs in
    float32, because the JAX divisor is a NumPy float64 scalar, which
    promotes a bfloat16 array to float32 (64-bit types off);
  - the probabilities are cast to the dtype of the *uncast* v before the
    PV product, so under "bfloat16" an f32 v makes that product float32 x
    bfloat16, which JAX promotes to float32. `torch.einsum` refuses mixed
    dtypes, so `_pv` writes the promotion out;
  - `attention` returns the dtype of that product, `finalize_accumulator`
    the dtype it is asked for (the ring asks for q's).
Under "float32" every call first turns TF32 off (`precision.
apply_backend_flags`), as every f32 forward of the port does.

Gradients follow JAX's where it matters: the running max is `torch.amax`
and `torch.maximum`, which split a tie's gradient evenly as JAX's max does,
and a fully masked row or block keeps its max finite (`m_safe`), its
correction 0 and its denominator 1, so neither the forward nor the
gradients carry a NaN where JAX's carry none.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import precision


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B, H, Lq, Lk] float32 scores: the product in the compute dtype, then
    the division by sqrt(d) in float32 (module docstring)."""
    s = torch.einsum("blhd,bmhd->bhlm", precision.cast_in(q),
                     precision.cast_in(k))
    return s.float() / math.sqrt(q.shape[-1])


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D]: `p` cast to v's own dtype times `cast_in(v)`, both
    promoted to their common dtype first (JAX's mixed-dtype einsum)."""
    a, b = p.to(v.dtype), precision.cast_in(v)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum("bhlm,bmhd->blhd", a.to(dt), b.to(dt))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact multi-head attention over [B, L, H, D] tensors."""
    precision.apply_backend_flags()
    s = _scores(q, k)
    if bias is not None:
        s = s + bias
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(lq, device=s.device)[:, None]
                >= torch.arange(lk, device=s.device)[None, :])
        s = torch.where(mask, s, -math.inf)
    return _pv(torch.softmax(s, dim=-1), v)


def block_accumulate(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     q: torch.Tensor, k_blk: torch.Tensor,
                     v_blk: torch.Tensor, k_offset: int, q_offset: int,
                     causal: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax step against a KV block.

    Running state: o [B, Lq, H, D] (unnormalized), m [B, H, Lq] (running
    max), l [B, H, Lq] (running denominator), all float32. The offsets are
    the GLOBAL positions of q[0] and k_blk[0], for the causal mask across
    shards. Returns the updated (o, m, l)."""
    precision.apply_backend_flags()
    s = _scores(q, k_blk)
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        qpos = q_offset + torch.arange(lq, device=s.device)
        kpos = k_offset + torch.arange(lk, device=s.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, -math.inf)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    # fully masked rows: keep m finite so exp() stays defined
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_new = l * corr + torch.sum(p, dim=-1)
    pv = _pv(p, v_blk).float()
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def init_accumulator(q_shape: Tuple[int, ...], device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The empty running state (o, m, l) for queries of `q_shape`."""
    b, lq, h, d = q_shape
    o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=device)
    m = torch.full((b, h, lq), -math.inf, dtype=torch.float32, device=device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=device)
    return o, m, l


def finalize_accumulator(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """o / l in `out_dtype`; a row that saw no key (l == 0) stays 0."""
    denom = torch.where(l == 0.0, 1.0, l).transpose(1, 2)[..., None]
    return (o / denom).to(out_dtype)
