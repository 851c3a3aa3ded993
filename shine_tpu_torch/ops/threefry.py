"""The parts of ``jax.random`` that the row-keyed datasets use, in plain
torch: the threefry2x32 hash and the samplers built on it, as JAX 0.9 draws
them with ``jax_threefry_partitionable`` on (its default).

A row-keyed base row is a pure function of ``fold_in(key, row_id)``
(``io/device_synth.py:regen_rows``), so the port regenerates the JAX
package's rows, queries and draws from the same seed. The integer stages
(keys, split keys, bits, ``randint``) and the uniforms are JAX's bit for
bit. ``normal`` is ``sqrt(2) * erf_inv(u)`` with XLA's f32 ``erf_inv`` (the
Giles polynomials of XLA's ``ErfInv32``, not ``torch.erfinv``, which is up
to ~90 ulps away); its one op that differs is ``log1p``: XLA's f32 log1p is
up to 2 ulps from the correctly rounded one that torch gives, so
``erf_inv`` is JAX's within 2 ulps and a normal (times sqrt(2)) within 3;
~99% of them are equal.

XLA on the CPU fuses a multiply followed by an add into one multiply-add
(the uniform's ``floats * span + min``, the polynomial's ``c + p * w``).
The port evaluates those two in f64 and rounds to f32: the product is exact
there, so the result is the fused one except on rare double-rounding ties.

uint32 words are held in int64 tensors and masked to 32 bits after every
add and shift. A key is an int64 tensor whose last axis holds its two
words, ``(..., 2)``; functions broadcast over the leading axes.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_MAX = 3.4028234663852886e38
# XLA's ErfInv32 coefficients, highest power first, for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the counter pair (x0, x1) under the key (k0,
    k1), JAX's 20-round schedule (``jax/_src/prng.py:_threefry2x32_lowering``).
    Any argument may be an int or an int64 tensor of uint32 values; they
    broadcast."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = torch.as_tensor(x0, dtype=torch.int64) + k0 & MASK
    x1 = torch.as_tensor(x1, dtype=torch.int64) + k1 & MASK
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.clone(), x1.clone()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            x1 = _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (2,) int64 [seed >> 32, seed & MASK]."""
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64)


def key_words(key: torch.Tensor) -> tuple[int, int]:
    """The two uint32 words of one key (2,), as ints."""
    k0, k1 = (int(v) for v in key.reshape(2).tolist())
    return k0, k1


def _words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    key = torch.as_tensor(key, dtype=torch.int64)
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter pair (0, data)
    (``prng.py:threefry_fold_in``). ``data`` (an int or an int tensor of
    values in [0, 2^32)) broadcasts against the key's leading axes."""
    k0, k1 = _words(key)
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(data, dtype=torch.int64, device=k0.device)
    data = data.to(torch.int64) & MASK
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    return torch.stack([o0, o1], dim=-1)


def _iota(shape: tuple[int, ...], device) -> torch.Tensor:
    """The row-major flat index of ``shape``, its low word (the high word
    is 0 below 2^32 elements): ``prng.py:iota_2x32_shape``."""
    n = 1
    for s in shape:
        n *= s
    if n >= 1 << 32:
        raise ValueError("shapes of 2^32 or more elements are not supported")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def _hash_iota(key: torch.Tensor, shape: tuple[int, ...]):
    """threefry of every counter (0, i) of ``shape`` under each key: two
    (..., *shape) word tensors."""
    k0, k1 = _words(key)
    lead = k0.dim()
    k0 = k0.reshape(k0.shape + (1,) * len(shape))
    k1 = k1.reshape(k1.shape + (1,) * len(shape))
    lo = _iota(tuple(shape), k0.device).reshape((1,) * lead + tuple(shape))
    return threefry2x32(k0, k1, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (the fold-like split of ``prng.py:1156``): key i
    is the hash of the counter pair (0, i). (..., 2) -> (..., num, 2)."""
    b0, b1 = _hash_iota(key, (num,))
    return torch.stack([b0, b1], dim=-1)


def random_bits32(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``prng.py:_threefry_random_bits_partitionable`` at 32 bits: the xor of
    the two hash words of each flat index. (..., 2) -> (..., *shape)."""
    b0, b1 = _hash_iota(key, tuple(shape))
    return b0 ^ b1


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32 (``jax/_src/random.py:_uniform``): 23
    random mantissa bits under exponent 0, minus 1, times (max - min) in
    f32, plus min as one multiply-add, then max(min, .)."""
    bits = random_bits32(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)  # < 2^31: no wrap
    floats = mant.view(torch.float32) - 1.0
    lo, hi = _f32(minval).to(floats.device), _f32(maxval).to(floats.device)
    return torch.maximum(lo, _mul_add(floats, hi - lo, lo))


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds (``random.py:_randint``): split
    once, two 32-bit draws, and the offset ((hi % span) * mult + lo % span)
    % span in wrapping uint32 arithmetic, mult = (2^16 % span)^2 % span.
    int64 values in [minval, maxval)."""
    keys = split(key, 2)
    higher = random_bits32(keys[..., 0, :], shape)
    lower = random_bits32(keys[..., 1, :], shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (65536 % span) * (65536 % span) & MASK
    mult %= span
    off = ((higher % span) * mult & MASK) + lower % span & MASK
    return minval + off % span


def _mul_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c as XLA's fused multiply-add: in f64, rounded to f32."""
    return (a.double() * b.double() + c.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``ErfInv32``: w = -log1p(-x^2); a degree-8 polynomial in w
    - 2.5 (w < 5) or sqrt(w) - 3 (else), each step c + p * w one
    multiply-add, times x; +-inf's stand-in x * f32max at |x| = 1."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lt5 = [_f32(c).to(x.device) for c in _ERFINV_LT5]
    ge5 = [_f32(c).to(x.device) for c in _ERFINV_GE5]
    p = torch.where(lt, lt5[0], ge5[0])
    for a, b in zip(lt5[1:], ge5[1:]):
        p = _mul_add(p, w, torch.where(lt, a, b))
    return torch.where(x.abs() == 1.0, x * F32_MAX, p * x)


# nextafter(-1, 0) in f32, the low end of normal's uniform
_NORMAL_LO = -0.99999994
SQRT2_F32 = 1.4142135381698608  # f32(sqrt(2)), 0x3FB504F3


def normal(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal`` in f32 (``random.py:_normal_real``): sqrt(2) *
    erf_inv(u), u uniform in (nextafter(-1, 0), 1)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _f32(SQRT2_F32).to(u.device) * erf_inv(u)
