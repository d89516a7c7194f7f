"""Layouts and plain-torch helpers shared by the step kernels.

The kernels take the engine's own layouts verbatim (JAX package
`kernels/layouts.py`):

- L1 row: [5 * W1 * S1] — five planes (tag/state/lru/ptr/epoch) at an
  FS = W1*S1 column stride, way w of set s of plane p at p*FS + w*S1 + s.
- Directory row: [DW] — tag/owner pairs at 2w / 2w+1, LRU at 2*W2 + w,
  epoch at 3*W2 + w, zero padding to MW = llc_meta_width, then sharer word
  n of way w at MW + w*NW + n.
- Lane vectors are [C] int32, one entry per core; step scalars are 0-d
  int32 device tensors that the kernels read through a pointer, so a step
  never waits for the host.
- Batched, every per-element tensor gains a leading element axis B (the
  fleet's: B independent simulations of one geometry): lanes [B, C],
  step scalars and latency knobs [B], the L1 [B, C, 5*W1*S1] and the
  directory [B, NS, DW]. The kernels take the batch and launch once for
  all of it; the wrappers also take the solo shapes, as a batch of one.

The helpers below are the plain versions of the device functions in
`csrc/common.cuh`: first-occurrence argmax/argmin (the JAX package's
tie-breaking) and a popcount that is right for words with bit 31 set.
"""

from __future__ import annotations

import torch


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word's 32-bit pattern (as __popc of the
    unsigned word), returned as int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def first_true(mask: torch.Tensor, dim: int = -1):
    """jnp.argmax semantics over `dim` of a bool tensor: (any, index of
    the first True, 0 when none), the index as int32."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    iota = torch.arange(n, dtype=torch.int32, device=mask.device).view(shape)
    idx = torch.where(mask, iota, n).amin(dim)
    any_ = idx < n
    return any_, torch.where(any_, idx, 0)


def first_min(vals: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jnp.argmin semantics over `dim` of an int32 tensor: index of the
    FIRST minimum, as int32."""
    n = vals.shape[dim]
    shape = [1] * vals.dim()
    shape[dim] = n
    iota = torch.arange(n, dtype=torch.int32, device=vals.device).view(shape)
    m = vals.amin(dim, keepdim=True)
    return torch.where(vals == m, iota, n).amin(dim)


def take(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mat[..., idx] along the last dim, one index per row: [..., W] and
    [...] int -> [...]."""
    return mat.gather(-1, idx.long().unsqueeze(-1)).squeeze(-1)


def unsqueeze_all(*ts):
    """Each tensor with a leading axis of 1 (a view); None passes."""
    return [t.unsqueeze(0) if torch.is_tensor(t) else t for t in ts]


def squeeze_all(ts):
    """Inverse of `unsqueeze_all` on a sequence of outputs."""
    return tuple(t[0] if torch.is_tensor(t) else t for t in ts)


def check_tensor(name, x, shape, device, dtype=torch.int32) -> None:
    """Raise ValueError unless `x` is a contiguous `dtype` tensor of
    `shape` on `device`: what a kernel's C interface takes."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(
            f"{name} must be contiguous {dtype} {list(shape)}, got "
            f"{x.dtype} {list(x.shape)}"
        )
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
