"""The reference's random streams: threefry-2x32 keys and draws in torch.

The reference draws every random number from ``jax.random`` with the
threefry-2x32 generator in its partitionable form: a draw of shape S from
key (k1, k2) hashes each element's flat index i, as the 64-bit counter
(i >> 32, i & 0xFFFFFFFF), under the key, and a 32-bit draw is the xor of
the hash's two words. The stream depends only on the key and the index, so
this module gives the same integers on the CPU, on the card and in the
reference, and a large draw can be made in chunks of the flat index
exactly (``CHUNK``), written into its output in place.

A key is a ``[2]`` int64 tensor holding the two uint32 words, on an
explicit device: draws land on the key's device (or on ``device=`` when
given), and on the meta device they give the shape only. Key arithmetic
(``split``, ``fold_in``) runs on the host in Python integers, two words at
a time. torch has no logical right shift for uint32 on the CPU, so the
hash works in int64 masked to 32 bits.

``normal`` is ``sqrt(2) * erf_inv(u)`` with u uniform on [nextafter(-1, 0),
1), as the reference's. ``erf_inv`` follows what XLA's CPU code computes
for it: Giles' single-precision polynomial over XLA's own ``log1p`` (a
Cephes rational function below sqrt(2) - 1, Cephes' ``logf`` above), with
the multiply-adds that XLA contracts into fused ones. A fused multiply-add
is one float64 product and sum rounded to float32, and a square root is
taken in float64 (torch's float32 one on the CPU is not correctly
rounded), so the CPU and the card round alike and match the reference
bit for bit but for a double rounding about once in 2^28 operations
(tests/test_torch_prng.py measures it).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
CHUNK = 1 << 22  # elements hashed at a time

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def _rotl(x, r):
    """Rotate 32-bit words left by r (int64 tensors or Python ints)."""
    if isinstance(x, int):
        return ((x << r) | (x >> (32 - r))) & _M
    t = torch.bitwise_left_shift(x, r)
    return x.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_and_(_M)


def threefry2x32(k1: int, k2: int, x0, x1):
    """The threefry-2x32 hash of the counter pair (x0, x1) under key (k1, k2):
    20 rounds, a key injection every 4 (``prng._threefry2x32_lowering``).
    x0 and x1 are Python ints or int64 tensors of uint32 values (overwritten)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    py = isinstance(x0, int)
    if py:
        x0, x1 = (x0 + ks[0]) & _M, (x1 + ks[1]) & _M
    else:
        x0.add_(ks[0]).bitwise_and_(_M)
        x1.add_(ks[1]).bitwise_and_(_M)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            if py:
                x0 = (x0 + x1) & _M
                x1 = _rotl(x1, r) ^ x0
            else:
                x0.add_(x1).bitwise_and_(_M)
                _rotl(x1, r).bitwise_xor_(x0)
        if py:
            x0 = (x0 + ks[(i + 1) % 3]) & _M
            x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
        else:
            x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M)
            x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M)
    return x0, x1


# ---------------------------------------------------------------------------
# Keys.
# ---------------------------------------------------------------------------


def _make(words, device) -> torch.Tensor:
    return torch.tensor(words, dtype=torch.int64, device=device)


def key(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (``threefry_seed``): the seed's high and
    low 32-bit words. The reference runs with 32-bit integers, so a seed
    in int32's range has high word 0 (a negative one too: its logical
    shift by 32 is 0)."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & _M
    return _make([hi, seed & _M], resolve_device(device))


def key_data(k: torch.Tensor) -> Tuple[int, int]:
    """The key's two words as Python ints (a host read for a card key)."""
    if k.shape != (2,):
        raise ValueError(f"a key is a [2] tensor; got shape {tuple(k.shape)}")
    w = k.tolist()
    return int(w[0]), int(w[1])


def split(k: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: keys [*num, 2], key i the hash of the counter i
    (``_threefry_split_foldlike``)."""
    shape = _shape(num)
    if k.device.type == "meta":
        return torch.empty((*shape, 2), dtype=torch.int64, device=k.device)
    k1, k2 = key_data(k)
    words = [threefry2x32(k1, k2, i >> 32, i & _M) for i in range(math.prod(shape))]
    return _make(words, k.device).reshape(*shape, 2)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter (0, data mod 2^32)."""
    if k.device.type == "meta":
        return torch.empty((2,), dtype=torch.int64, device=k.device)
    k1, k2 = key_data(k)
    return _make(list(threefry2x32(k1, k2, 0, int(data) & _M)), k.device)


# ---------------------------------------------------------------------------
# Draws.
# ---------------------------------------------------------------------------


def _bits_range(k1: int, k2: int, start: int, stop: int, device) -> torch.Tensor:
    """The 32-bit draw of flat indices [start, stop) as int64 (``bits1 ^ bits2``)."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    hi = torch.bitwise_right_shift(idx, 32) if stop > (1 << 32) else torch.zeros_like(idx)
    b0, b1 = threefry2x32(k1, k2, hi, idx.bitwise_and_(_M))
    return b0.bitwise_xor_(b1)


def _target(k: torch.Tensor, device) -> torch.device:
    return k.device if device is None else resolve_device(device)


def _fill(k: torch.Tensor, shape, dtype, device, out, chunk_fn) -> torch.Tensor:
    """Fill ``out`` (or a new tensor) chunk by chunk over the flat index:
    ``chunk_fn(bits)`` maps a chunk's 32-bit draws to its values."""
    dev = _target(k, device) if out is None else out.device
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=dev)
    elif tuple(out.shape) != shape:
        raise ValueError(f"out has shape {tuple(out.shape)}, the draw {shape}")
    if dev.type == "meta":
        return out
    k1, k2 = key_data(k)
    flat = out.view(-1)
    n = flat.numel()
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        flat[s:e] = chunk_fn(_bits_range(k1, k2, s, e, dev))
    return out


def bits(k: torch.Tensor, shape: Shape = (), *, device=None) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): uint32 values held as int64."""
    return _fill(k, _shape(shape), torch.int64, device, None, lambda b: b)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as XLA's CPU code contracts it: the
    product is exact in float64 and the sum rounds to float64, then to
    float32 (a second rounding that changes the result about once in 2^28)."""
    if isinstance(b, torch.Tensor):
        b = b.to(torch.float64)
    if isinstance(c, torch.Tensor):
        c = c.to(torch.float64)
    return (a.to(torch.float64) * b + c).to(torch.float32)


def _unit(b: torch.Tensor) -> torch.Tensor:
    """Mantissa bits over 1.0, minus 1: floats in [0, 1) (``random._uniform``)."""
    return b.bitwise_right_shift_(9).bitwise_or_(0x3F800000).to(torch.int32) \
        .view(torch.float32).sub_(1.0)


def _scaled_uniform(b: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """floats * (maxval - minval) + minval (one fused multiply-add, as XLA
    contracts it), then at least minval."""
    lo = _f32(minval)
    span = _f32(np.float32(maxval) - np.float32(minval))
    u = _unit(b)
    if span != 1.0 or lo != 0.0:
        u = _fma(u, span, lo)
    return u.clamp_(min=lo)


def uniform(k: torch.Tensor, shape: Shape = (), minval: float = 0.0, maxval: float = 1.0,
            *, device=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval)."""
    return _fill(k, _shape(shape), torch.float32, device, out,
                 lambda b: _scaled_uniform(b, minval, maxval))


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    r = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        r = _fma(r, x, _f32(c))
    return r


# XLA's log1p below sqrt(2) - 1 (Cephes' rational approximation) ...
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553540197041E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# ... and its log above (Cephes' logf polynomial, ln 2 split in two).
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """log of positive float32 ``x`` as XLA's CPU code computes it: the
    mantissa in [sqrt(1/2), sqrt(2)) minus 1, a degree-8 polynomial, and
    the exponent times ln 2 as 0.693359375 - 2.12194440e-4."""
    x = torch.clamp(x, min=_f32(np.finfo(np.float32).tiny))
    xb = x.view(torch.int32)
    e = (torch.bitwise_right_shift(xb, 23) - 127).to(torch.float32).add_(1.0)
    m = (xb & ~0x7F800000 | 0x3F000000).view(torch.float32)
    small = m < _f32(0.707106781186547524)
    t = torch.where(small, m, 0.0)
    m = m - 1.0
    e = e - torch.where(small, 1.0, 0.0)
    m = m + t
    x2 = m * m
    x3 = x2 * m
    p = [_f32(c) for c in _LOG_P]
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _f32(-2.12194440e-4))
    m = _fma(x2, -0.5, m)
    return _fma(e, _f32(0.693359375), m + y)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """log(1 + x) of float32 ``x`` > -1 as XLA's CPU code computes it."""
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    r = _fma(x2, -0.5, (x * x2) * r)
    small = x.abs() < _f32(0.41421356237309504880)
    return torch.where(small, x + r, _xla_log(x + 1.0))


# XLA's float32 erf_inv (Giles' polynomial), for w < 5 and for w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """erf^-1 of float32 ``x`` in (-1, 1) as XLA expands it on the CPU:
    w = -log1p(-x^2); below 5, a degree-8 polynomial in w - 2.5, else in
    sqrt(w) - 3; times x; +-inf at +-1."""
    w = _xla_log1p(x * -x).neg_()
    lt = w < 5.0
    root = torch.sqrt(w.to(torch.float64)).to(torch.float32)
    w = torch.where(lt, w - 2.5, root.sub_(3.0))
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, _f32(a), _f32(b)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_SQRT2 = _f32(np.sqrt(2.0))
_NORMAL_LO = _f32(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _normal_chunk(b: torch.Tensor, mul, div) -> torch.Tensor:
    z = erf_inv(_scaled_uniform(b, _NORMAL_LO, 1.0)).mul_(_SQRT2)
    if mul is not None:
        z.mul_(_f32(mul))
    if div is not None:
        z.div_(_f32(div))
    return z


def normal(k: torch.Tensor, shape: Shape = (), *, mul: Optional[float] = None,
           div: Optional[float] = None, dtype=torch.float32, device=None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.normal`` in float32, times ``mul`` or over ``div`` (each
    a float32 scalar, as the reference scales its inits), then cast to
    ``dtype`` (or to ``out``'s, written in place), a chunk at a time."""
    return _fill(k, _shape(shape), dtype, device, out, lambda b: _normal_chunk(b, mul, div))


def _mulmod32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 values in int64, without overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M


def randint(k: torch.Tensor, shape: Shape, minval: int, maxval: int, *,
            device=None) -> torch.Tensor:
    """``jax.random.randint`` for int32: two 32-bit draws (``split``) combined
    modulo the span with uint32 wrapping, as ``random._randint``."""
    shape = _shape(shape)
    dev = _target(k, device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.int32, device=dev)
    lo32, hi32 = -(1 << 31), (1 << 31) - 1
    minval = min(max(int(minval), lo32), hi32)
    maxval_in = int(maxval)
    maxval = min(max(maxval_in, lo32), hi32)
    span = (maxval - minval) & _M
    if maxval <= minval:
        span = 1
    elif maxval_in > hi32:
        span = (span + 1) & _M
    k1, k2 = split(k)
    higher = bits(k1, shape, device=dev)
    lower = bits(k2, shape, device=dev)
    if span == 0:  # uint32 remainders by 0 keep their operand: the offset is ``lower``
        off = lower
    else:
        mult = (1 << 16) % span
        mult = ((mult * mult) & _M) % span  # the square wraps in uint32, as the reference's
        off = _mulmod32(higher % span, mult)
        off = (off + lower % span) & _M
        off = off % span
    val = (off + minval) & _M
    return torch.where(val >= (1 << 31), val - (1 << 32), val).to(torch.int32)


def bernoulli(k: torch.Tensor, p: float = 0.5, shape: Shape = (), *,
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode low): a float32 uniform below ``p``."""
    return uniform(k, shape, device=device) < _f32(p)


def permutation(k: torch.Tensor, n: int, *, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (``random._shuffle``): arange(n)
    sorted by fresh 32-bit keys, stably, ceil(3 ln n / ln(2^32 - 1)) times."""
    dev = _target(k, device)
    x = torch.arange(n, dtype=torch.int64, device=dev)
    if dev.type == "meta":
        return x
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(bits(sub, (n,), device=dev), stable=True).indices
        x = x[order]
    return x


def choice(k: torch.Tensor, n: int, shape: Shape = (), replace: bool = True,
           p: Optional[torch.Tensor] = None, *, device=None) -> torch.Tensor:
    """``jax.random.choice`` over arange(n) (int64 indices).

    Without ``p``: ``randint`` with replacement, the first draws of
    ``permutation`` without. With ``p`` (and replacement): the first index
    whose float32 cumulative sum reaches ``total * (1 - uniform)``; the
    reference sums in XLA's order, so an index next to a bucket edge may
    differ (``index/kmeans.py`` maps the same target onto an exact sum)."""
    shape = _shape(shape)
    n_draws = math.prod(shape)
    if not replace and n_draws > n:
        raise ValueError(f"cannot take {n_draws} of {n} without replacement")
    dev = _target(k, device)
    if p is None:
        if replace:
            return randint(k, shape, 0, n, device=dev).to(torch.int64)
        return permutation(k, n, device=dev)[:n_draws].reshape(shape)
    if not replace:
        raise NotImplementedError("choice with p and without replacement")
    cum = torch.cumsum(p.to(dev, torch.float32), 0)
    r = cum[-1] * (1.0 - uniform(k, shape, device=dev))
    return torch.searchsorted(cum, r.reshape(-1)).reshape(shape)
