"""``jax.random``'s threefry stream in PyTorch, bit for bit.

The serving path samples from per-request key streams that must give the
JAX package's tokens, so this module reproduces JAX's default PRNG —
``threefry2x32`` with ``jax_threefry_partitionable=True`` (the default
from JAX 0.5 on) — exactly:

- :func:`PRNGKey` — a key from an integer seed: ``[0, seed &
  0xFFFFFFFF]`` (JAX with 64-bit types off, its default);
- :func:`fold_in` — ``threefry(key, (0, data))``;
- :func:`split` — key ``i`` is ``threefry(key, (0, i))`` (the
  partitionable layout: a 64-bit counter split into a high and a low
  word, ``iota_2x32_shape``);
- :func:`random_bits` — 32-bit words ``bits1 ^ bits2`` of the hash of
  the same 64-bit counter over the flattened shape;
- :func:`uniform` — f32 by the mantissa trick (``bits >> 9 |
  0x3F800000`` viewed as a float in [1, 2), minus 1), scaled, and
  clamped below at ``minval``;
- :func:`gumbel` — ``-log(-log(uniform(tiny, 1)))`` (JAX's default
  ``mode="low"``), with the logarithm XLA's CPU backend computes
  (:func:`xla_log`), so the noise is bitwise JAX's and the same on the
  card as on the CPU;
- :func:`categorical` — ``argmax(gumbel + logits)``, ties to the first
  index.

A key is an int64 tensor ``[..., 2]`` holding two unsigned 32-bit words.
torch has no full uint32 arithmetic, so words live in int64 and every
sum is masked back to 32 bits; rotations use shifts of non-negative
values, so a right shift is logical. Leading key dimensions batch the
call the way ``jax.vmap`` over keys does: each key draws its own
``shape`` from its own counter range. The module serves sampling only;
weights keep their explicit ``torch.Generator``.
"""

from __future__ import annotations

import struct

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: smallest normal f32 (``jnp.finfo(jnp.float32).tiny``)
_F32_TINY = 1.1754943508222875e-38


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; all int64 tensors of 32-bit values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _as_key(key, device=None) -> torch.Tensor:
    k = torch.as_tensor(key, device=device)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key has a trailing dimension of 2, got shape "
                         f"{tuple(k.shape)}")
    return k.to(torch.int64) & _MASK


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (JAX's)
    """``jax.random.PRNGKey(seed)`` as JAX computes it with 64-bit types
    off (its default): the seed wraps to 32 bits, so the key is ``[0,
    seed & 0xFFFFFFFF]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _hash_counter(key, hi, lo):
    """``threefry(key, (hi, lo))`` for counters broadcast against the
    key's batch dimensions; returns the two output words."""
    return threefry2x32(key[..., 0], key[..., 1], hi, lo)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``data`` an int or an integer
    tensor broadcast against the key's batch dimensions (what
    ``jax.vmap(fold_in)(keys, data)`` gives). ``data`` is taken modulo
    2**32, as JAX's uint32 conversion does."""
    key = _as_key(key)
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    b1, b2 = _hash_counter(key, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` → ``[num, 2]`` (a batch of keys
    ``[..., 2]`` gives ``[..., num, 2]``)."""
    key = _as_key(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = _hash_counter(key[..., None, :], torch.zeros_like(i), i)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(key, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` at 32 bits: int64 values in [0,
    2**32), shape ``key.shape[:-1] + shape``."""
    key = _as_key(key)
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n >= 1 << 32:
        raise NotImplementedError("random bits past 2**32 elements per key")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    batch = key.shape[:-1]
    k = key.reshape(batch + (1,) * len(shape) + (2,))
    b1, b2 = _hash_counter(k, torch.zeros_like(lo), lo)
    return b1 ^ b2


def _fma(a, b, c):
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the f64
    product of two f32 values is exact, so only the f64 sum rounds before
    the f32 result (a double rounding that differs from a true FMA only
    when the f64 sum lands exactly on an f32 half-way point)."""
    return (torch.as_tensor(a, dtype=torch.float64)
            * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).float()


def uniform(key, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``; the
    scale-and-shift is one fused multiply-add, as XLA compiles it."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def _f32(v: float) -> float:
    """``v`` rounded to the nearest f32 (the constants below are f32 in
    XLA's code)."""
    return struct.unpack("<f", struct.pack("<f", v))[0]


#: Cephes coefficients of XLA's f32 logarithm on the CPU
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """The natural log of positive finite f32 ``x`` exactly as XLA's CPU
    backend computes it (its vectorized Cephes polynomial, with the
    multiply-adds the compiler fuses), not the correctly rounded one:
    ``torch.log`` and XLA's differ in the last bit on many Gumbel
    draws, which would change sampled tokens at near-ties.
    Denormals are flushed to the smallest normal first, as XLA does."""
    x = torch.clamp_min(x.float(), _F32_TINY)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _SQRTHF
    e = e - low.float()
    t = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)           # f32 product, then fused
    t = _fma(-0.5, x2, t)
    t = t + y
    return _fma(_LOG_Q2, e, t)


def gumbel(key, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in JAX's default
    ``mode="low"``, bitwise (through :func:`xla_log`)."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0)
    return -xla_log(-xla_log(u))


def categorical(key, logits, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` for one key: Gumbel
    noise of ``logits``' shape, then the argmax along ``axis`` (first
    index on ties). A key per row — ``jax.vmap(categorical)(keys,
    logits)`` — is ``argmax(gumbel(keys, (V,)) + logits)``."""
    key = _as_key(key, logits.device)
    if key.dim() != 1:
        raise ValueError("categorical takes one key")
    g = gumbel(key, tuple(logits.shape))
    return torch.argmax(g + logits, dim=axis)
