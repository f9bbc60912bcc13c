"""Counter-based, position-seedable RNG for wavefront kernels.

Bit-exact counterpart of the JAX package's `rng.py`: draw k of stream s
is ``mix(s, k)``, a murmur3-style avalanche over 32-bit lanes, and a
stream id is a hash of the f32 bits of a surface point (the
v3d_s_random_seed analog, reference src/vectors.h:177-190).

PyTorch on the CPU has no right shift for uint32, so a "u32" here is an
int64 tensor holding a value in [0, 2^32).  Every step masks back to 32
bits, and products are formed from 16-bit halves of the constant, so no
intermediate leaves the int64 range.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul32(h, m: int):
    """(h * m) mod 2^32 for h in [0, 2^32) and a 32-bit constant m."""
    lo = h * (m & 0xFFFF)
    hi = (h * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def _fmix32(h):
    """murmur3 finalizer — full-avalanche 32-bit mixer."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    return h


def as_u32(x, device=None):
    """A tensor (or int) as the int64 representation of uint32 values.
    An int becomes a fill on `device`, not an upload: a drain trip
    captured as a CUDA graph may not copy from the host."""
    if isinstance(x, (int, np.integer)):
        return torch.full((), int(x) & _MASK, dtype=torch.int64,
                          device=device)
    t = torch.as_tensor(x, device=device)
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.to(torch.int64) & _MASK


def mix(seed, counter):
    """One 32-bit draw of stream `seed` at position `counter`
    (broadcast)."""
    seed = as_u32(seed)
    counter = as_u32(counter, device=seed.device)
    return _fmix32(seed ^ _fmix32((_mul32(counter, _GOLDEN) + 1) & _MASK))


def uniform(seed, counter, dtype=torch.float32):
    """Uniform in [0, 1): top 24 bits of the draw."""
    bits = mix(seed, counter)
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


def uniform_signed(seed, counter, dtype=torch.float32):
    """Uniform in (-1, 1), the f3_rnd0 analog (reference
    src/vectors.h:45)."""
    return uniform(seed, counter, dtype) * 2.0 - 1.0


def seed_from_v3(pos, salt: int):
    """Deterministic stream id from a 3-D position: a hash of the f32
    coordinate bits, mixed per component with distinct salts."""
    bits = pos.detach().to(torch.float32).contiguous().view(torch.int32)
    bits = bits.to(torch.int64) & _MASK
    s = salt & _MASK
    h = _fmix32(bits[..., 0] ^ s)
    h = _fmix32(bits[..., 1] ^ _mul32(h, _M1))
    h = _fmix32(bits[..., 2] ^ _mul32(h, _M2))
    return h


def fold(seed_a, seed_b):
    """Combine two stream ids."""
    return _fmix32(_mul32(as_u32(seed_a), _M1) ^ _mul32(as_u32(seed_b),
                                                         _M2))


def to_uint32(h):
    """The int64 representation as a torch.uint32 tensor (the kernels'
    input type)."""
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(
        torch.int32).view(torch.uint32)


# --------------------------------------------------------------------------
# host-side sequential generator (sample-position generation, envelope
# estimation): mirrors the role of beth's bcore_lcg00_u3 stream
# (reference src/vectors.h:45-48) with Knuth MMIX constants.

_LCG_MUL = np.uint64(6364136223846793005)
_LCG_ADD = np.uint64(1442695040888963407)


class HostLcg:
    """Sequential 64-bit LCG for host-side (scene build / driver)
    sampling."""

    def __init__(self, state: int):
        self.state = np.uint64(state)

    def next_u64(self) -> np.uint64:
        with np.errstate(over="ignore"):
            self.state = self.state * _LCG_MUL + _LCG_ADD
        return self.state

    def rnd1(self) -> float:
        """Uniform in (0, 1) (f3_rnd1 analog, reference
        src/vectors.h:48)."""
        return float(self.next_u64()) * (1.0 / float(0xFFFFFFFFFFFFFFFF))

    def rnd0(self) -> float:
        """Uniform in (-1, 1) (f3_rnd0 analog, reference
        src/vectors.h:45)."""
        return self.rnd1() * 2.0 - 1.0

    def sphere_belt(self, h: float) -> np.ndarray:
        """v3d_s_random_sphere_belt analog (reference
        src/vectors.h:209-218)."""
        phi = 2.0 * np.pi * self.rnd1()
        z = self.rnd0() * h
        scale = np.sqrt(max(1.0 - z * z, 0.0))
        return np.array([np.sin(phi) * scale, np.cos(phi) * scale, z])
