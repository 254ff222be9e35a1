"""The day's random stream, jax's threefry2x32 in torch: a frozen copy of
the program's ``core/prng.py``, so that the reference draws the numbers
the program draws for the same keys.

* ``threefry2x32`` is Threefry-2x32 (20 rounds, key schedule ``k1, k2,
  k1 ^ k2 ^ 0x1BD11BDA``);
* ``split`` hashes the 64-bit iota of the output shape, ``fold_in`` the
  count pair ``(0, data)``, ``random_bits`` the 64-bit iota, its two
  halves xored;
* ``randint``, ``uniform`` and ``normal`` are jax's ``_randint``,
  ``_uniform`` and ``_normal_real`` (sqrt(2) * erfinv of a uniform on
  (-1, 1), erfinv by XLA's single-precision polynomial).

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
unsigned 32-bit arithmetic is emulated in int64 with ``& 0xFFFFFFFF``. A
batch of keys gives, for each key, what the single-key call gives.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# erfinv single-precision polynomial (M. Giles), as XLA lowers chlo.erf_inv
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# Cephes log and log1p coefficients (highest degree first)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)

Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 hash of the count pairs ``(x1, x2)`` under the key
    ``(k1, k2)``. All int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    y0 = (x1 + ks[0]) & MASK
    y1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0 = (y0 + y1) & MASK
            y1 = _rotl(y1, r) ^ y0
        y0 = (y0 + ks[(i + 1) % 3]) & MASK
        y1 = (y1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return y0, y1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed: (2,)."""
    if not 0 <= int(seed) <= MASK:
        raise ValueError(f"seed must be a uint32, got {seed}")
    return torch.tensor([0, int(seed)], dtype=torch.int64, device=device)


def _shape(shape: Shape):
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _iota_hash(key: torch.Tensor, shape):
    """Hash the 64-bit iota of ``shape`` under each key of ``key`` (..., 2):
    returns the two uint32 halves, each of shape (..., *shape)."""
    size = math.prod(shape)
    idx = torch.arange(size, dtype=torch.int64, device=key.device)
    hi, lo = (idx >> 32).reshape(shape), (idx & MASK).reshape(shape)
    pad = (1,) * len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + pad)
    k2 = key[..., 1].reshape(key.shape[:-1] + pad)
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    b1, b2 = _iota_hash(key, (int(num),))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: (..., 2) and an int or an integer tensor
    that broadcasts against the key batch -> (..., 2)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element: (..., 2) -> int64 (..., *shape)."""
    b1, b2 = _iota_hash(key, _shape(shape))
    return b1 ^ b2


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` for int32 (``_randint``): (..., 2) -> int64
    (..., *shape) in [minval, maxval).

    Two 32-bit draws from the two halves of ``split(key)`` are reduced
    modulo the span as one 64-bit number: ``(hi % span) * (2**32 % span) +
    lo % span``, all in wrapping uint32 arithmetic, then ``% span`` again.
    ``maxval <= minval`` gives ``minval``."""
    lo_v, hi_v = int(minval), int(maxval)
    if not -2**31 <= lo_v <= hi_v <= 2**31 - 1:
        raise ValueError(f"int32 range expected, got [{minval}, {maxval})")
    span = max(hi_v - lo_v, 1)
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    mult = ((2**16 % span) ** 2 & MASK) % span
    off = ((higher % span) * mult & MASK) + lower % span
    return lo_v + (off & MASK) % span


def uniform(key: torch.Tensor, shape: Shape, minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """``jax.random.uniform`` in float32: (..., 2) -> (..., *shape)."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA contracts the scale-and-shift into one fused multiply-add
    return torch.maximum(lo, _fma(f, hi - lo, lo))


def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add (the product of two float32 is exact in
    float64; one rounding after the add, one back to float32). Python
    floats are constants and are rounded to float32 first."""
    def d(v):
        if isinstance(v, torch.Tensor):
            return v.double()
        return float(torch.tensor(v, dtype=torch.float32))
    return (d(a) * d(b) + d(c)).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive x by the Cephes polynomial with
    fused multiply-adds, as XLA's CPU backend evaluates it."""
    m, e = torch.frexp(x)
    e = e.to(torch.float32)
    small = m < 0.707106781186547524
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    y = _fma(_LOG_P[0], m, _LOG_P[1])
    y1 = _fma(_LOG_P[3], m, _LOG_P[4])
    y2 = _fma(_LOG_P[6], m, _LOG_P[7])
    y = _fma(y, m, _LOG_P[2])
    y1 = _fma(y1, m, _LOG_P[5])
    y2 = _fma(y2, m, _LOG_P[8])
    y = _fma(y, m3, y1)
    y = _fma(y, m3, y2) * m3
    y = _fma(-2.12194440e-4, e, y)
    m = (m - m2 * 0.5) + y
    return _fma(0.693359375, e, m)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p as XLA evaluates it: a Cephes rational function for
    |x| < sqrt(2) - 1, log(1 + x) elsewhere."""
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, x, c)
    den = torch.full_like(x, _LOG1P_DEN[0])
    for c in _LOG1P_DEN[1:]:
        den = _fma(den, x, c)
    x2 = x * x
    near0 = x + _fma(-0.5, x2, x * x2 * (num / den))
    return torch.where(x.abs() < 0.41421356237309504880, near0,
                       _log(1.0 + x))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, the polynomial XLA evaluates."""
    w = -_log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, c_lt, c_ge))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: (..., 2) -> (..., *shape)."""
    return _SQRT2 * erfinv(uniform(key, shape, _NORMAL_LO, 1.0))
