"""Counter-based fault PRNG: hash (seed, step, site) -> uniform uint32,
the JAX package's `faults/prng.py`.

Every draw is a pure function of the simulation seed, the step number and
a site id, so a schedule replays bit-exactly and the host can predict the
device's draws (`site_hash_np`). The mixer is the murmur3 fmix32
finalizer over a Weyl-style combination of the inputs. A draw fires an
event of probability p when `hash < prob_threshold(p)`, compared as
unsigned 32-bit values.

torch has no complete uint32 arithmetic, so `site_hash` works in int64
holding values in [0, 2^32): right shifts are then logical, the unsigned
compare is a plain `<`, and `_mul32` multiplies modulo 2^32 in 16-bit
halves so that no int64 product overflows. `prob_threshold(1.0)` is
0xFFFFFFFF, which the port's fault state holds in int64 as well.
"""

from __future__ import annotations

import numpy as np
import torch

# distinct odd constants decorrelate the step and site counters
_STEP_MUL = 0x9E3779B9
_SITE_MUL = 0x85EBCA77
#: salt for the second (DUE-classification) draw per site
DUE_SALT = 0x2545F491
_U32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor's low 32 bits as an int64 tensor in [0, 2^32)
    (an int32 value is reinterpreted as uint32, as JAX's astype does)."""
    return x.to(torch.int64) & _U32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    with every partial product below 2^49."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _U32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 tensors in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def site_hash(seed, step, site, salt=0) -> torch.Tensor:
    """Uniform draw for (seed, step, site) as int64 in [0, 2^32). `seed` a
    scalar tensor holding a uint32 value, `step` the state's int32 step
    (cast to uint32 as JAX casts it), `site` an integer tensor; `salt` an
    int or an integer tensor that broadcasts against `site`."""
    salt = _u32(salt) if torch.is_tensor(salt) else salt & _U32
    x = (
        _u32(seed) ^ salt
        ^ _mul32(_u32(step), _STEP_MUL)
        ^ _mul32(_u32(site), _SITE_MUL)
    )
    return fmix32(x)


def site_hash_np(seed: int, step, site, salt: int = 0) -> np.ndarray:
    """Host-side twin of `site_hash` (uint32 numpy, bit-identical)."""
    with np.errstate(over="ignore"):
        x = (
            np.uint32(seed)
            ^ np.uint32(salt)
            ^ (np.asarray(step, np.uint32) * np.uint32(_STEP_MUL))
            ^ (np.asarray(site, np.uint32) * np.uint32(_SITE_MUL))
        )
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    return x


def prob_threshold(p: float) -> np.uint32:
    """Probability -> uint32 compare threshold (fires when hash < t)."""
    return np.uint32(min(0xFFFFFFFF, int(round(float(p) * 4294967296.0))))
