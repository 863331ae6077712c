"""Counter-based random numbers that reproduce ``jax.random`` bit for bit.

The JAX package draws its TRNOISE realisations with ``jax.random`` (the
threefry2x32 generator in its partitionable form).  A deck run noisy in
the port must give the same realisation from the same seed, so this
module recomputes JAX's stream in torch:

- a key is an int64 tensor (..., 2) of two uint32 words; ``key(seed)`` is
  [seed >> 32, seed & 0xffffffff] (seed taken as 64 bits);
- ``threefry2x32(k0, k1, x0, x1)`` is the 20-round Threefry-2x32 of
  Salmon et al. (rotations 13 15 26 6 / 17 29 16 24, a key injection
  every four rounds with its counter added to x1, k2 = k0 ^ k1 ^
  0x1BD11BDA), as ``jax._src.prng.threefry_2x32`` computes it;
- ``fold_in(k, d)`` and ``split(k, n)[c]`` are threefry2x32(k, (0, d))
  and threefry2x32(k, (0, c));
- the bits of element c (row-major flat index) of a shape are
  threefry2x32(k, (c >> 32, c & 0xffffffff)) = (a, b), a ^ b for 32-bit
  bits and (a << 32) | b for 64-bit ones;
- ``normal``: the top mantissa bits make u in [1, 2), then
  u = max(lo, 2 (u - 1) + lo) with lo = nextafter(-1, 0) in the working
  type, and sqrt(2) erfinv(u).  erfinv is the polynomial of M. Giles
  ("Approximating the erfinv function", GPU Computing Gems, 2011) that
  XLA evaluates, in each type: in float64 it keeps JAX's normals within
  1e-15 (torch's own erfinv parts from it by 1e-11 in the tails); in
  float32 it runs with XLA's CPU log1p and fused multiply-adds, emulated
  through float64, and agrees with JAX to 2 ulp, bit for bit in all but
  a few draws in 10^5.  Both are built from arithmetic alone (no torch
  transcendental), so a draw is the same bits on the CPU and on CUDA and
  wherever it sits in its tensor.

The uint32 arithmetic runs in int64 tensors masked with 0xffffffff (the
same code on the CPU and on CUDA, where torch's uint32 has few
operations).  Every function broadcasts over leading axes, so a batch of
lanes, steps and sources draws in one call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# erfinv in float32 (Giles): w = -log1p(-x^2); w < 5 takes the first set
# on w - 2.5, else the second on sqrt(w) - 3; Horner from the first entry
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)
# erfinv in float64 (Giles): w < 6.25 on w - 3.125, w < 16 on sqrt(w) -
# 3.25, else on sqrt(w) - 5; the shorter sets end the Horner chain early
_ERFINV64_W_LT_625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_W_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_W_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def key(seed: int, device=None) -> torch.Tensor:
    """The key data of ``jax.random.key(seed)``: (2,) int64."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & MASK], dtype=torch.int64,
                        device=device)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key words (k0, k1); all int64 tensors (or ints) holding uint32 values,
    broadcast together.  Returns the two output words (fresh tensors,
    updated in place round by round)."""
    k0 = torch.as_tensor(k0)
    dev = k0.device
    k1, x0, x1 = (torch.as_tensor(v, device=dev) for v in (k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    x0, x1 = (v.contiguous() for v in torch.broadcast_tensors(x0, x1))
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            high = (x1 << r).bitwise_and_(MASK)      # rotate left by r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(high)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return x0, x1


def _words(k):
    return k[..., 0], k[..., 1]


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: (..., 2) keys, integer data broadcast
    against the keys' leading axes."""
    d = torch.as_tensor(data, device=k.device).to(torch.int64) & MASK
    a, b = threefry2x32(*_words(k), 0, d)
    return torch.stack([a, b], -1)


def split(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(k, n)``: (..., 2) -> (..., n, 2)."""
    c = torch.arange(n, dtype=torch.int64, device=k.device)
    a, b = threefry2x32(k[..., None, 0], k[..., None, 1], 0, c)
    return torch.stack([a, b], -1)


def _counter_words(k, counters):
    """threefry2x32(k, (c >> 32, c & mask)) for int64 flat indices c."""
    c = torch.as_tensor(counters, device=k.device).to(torch.int64)
    return threefry2x32(*_words(k), c >> 32, c & MASK)


def _flat_counters(k, shape):
    """Keys (..., 2) and the flat indices of ``shape`` laid out so that
    they broadcast to (..., *shape)."""
    shape = tuple(shape)
    c = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=k.device).reshape(shape)
    return k.reshape(k.shape[:-1] + (1,) * len(shape) + (2,)), c


def bits(k: torch.Tensor, shape=(), width: int = 32) -> torch.Tensor:
    """``jax.random.bits`` of ``shape`` under keys (..., 2) as int64
    (..., *shape): 32-bit values as they are, 64-bit ones as the int64 of
    the same bits (numpy's ``uint64.view(int64)``)."""
    a, b = _counter_words(*_flat_counters(k, shape))
    if width == 32:
        return a ^ b
    if width == 64:
        hi = torch.where(a >= 1 << 31, a - (1 << 32), a)
        return hi * (1 << 32) + b
    raise ValueError(f"width {width}: 32 or 64")


def _f32(c: float) -> float:
    """The float32 value of the constant c, as a Python float."""
    return float(np.float32(c))


def _fma32(a, b, c):
    """a * b + c of float32 operands rounded to float32 as one fused
    multiply-add rounds it: the product is exact in float64, the sum
    rounds to float64 and then to float32 (a second rounding that can
    differ from the FMA's only at an exact float32 tie)."""
    return (a.double() * b + c).float()


def _horner32(coefs, x):
    """Horner's rule in float32 with a fused multiply-add per step (XLA's
    polynomial evaluation on the CPU), from the first coefficient."""
    r = torch.full_like(x, _f32(coefs[0]))
    for c in coefs[1:]:
        r = _fma32(r, x, _f32(c))
    return r


# log1p in float32 as XLA's CPU code emits it: for |x| < sqrt(2) - 1 a
# rational approximation of (log1p(x) - x + x^2/2) / x^3 (Cephes), else
# log(1 + x) with Cephes' logf on the mantissa and exponent
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
           -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
           2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _logf(v: torch.Tensor) -> torch.Tensor:
    """Cephes logf for positive normal float32 v."""
    bits32 = v.view(torch.int32)
    e = (bits32 >> 23) - 0x7F
    m = ((bits32 & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [.5, 1)
    low = m < _f32(0.707106781186547524)
    e = (e.to(torch.float32) + 1.0) - low.to(torch.float32)
    t = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = t * t
    x3 = x2 * t
    p = [_f32(c) for c in _LOGF_P]
    y = _fma32(t, p[0], p[1])
    y1 = _fma32(t, p[3], p[4])
    y2 = _fma32(t, p[6], p[7])
    y = _fma32(y, t, p[2])
    y1 = _fma32(y1, t, p[5])
    y2 = _fma32(y2, t, p[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2) * x3
    y = y + _f32(-2.12194440e-4) * e
    t = t - 0.5 * x2
    return (t + y) + _f32(0.693359375) * e


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """log1p of float32 x in (-1, 0] as XLA's CPU code computes it (its
    small branch bit for bit, the logf branch to an ulp)."""
    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (_horner32(_LOG1P_NUM, x)
                                          / _horner32(_LOG1P_DEN, x)))
    big = _logf(torch.clamp_min(x + 1.0, torch.finfo(torch.float32).tiny))
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, big)


def _horner64(coefs, x):
    r = torch.full_like(x, coefs[0])
    for c in coefs[1:]:
        r = r * x + c
    return r


def _log1p_f64(y: torch.Tensor) -> torch.Tensor:
    """log1p of float64 y in (-1, 0] from arithmetic alone, so the value of
    an element depends neither on the device nor on where it sits in its
    tensor (torch's CPU log1p takes a vectorised routine in the body of an
    array and another in its tail): Cephes' rational form for
    |y| < sqrt(2) - 1, else log(1 + y) as e ln 2 + log1p(m - 1) with the
    mantissa m in [sqrt(1/2), sqrt(2)) (ln 2 in two parts)."""
    y2 = y * y

    def rational(x, x2):
        return x + (-0.5 * x2 + (x * x2) * (_horner64(_LOG1P_NUM, x)
                                           / _horner64(_LOG1P_DEN, x)))

    v = 1.0 + y
    bits64 = v.view(torch.int64)
    e = (bits64 >> 52) - 1022
    m = ((bits64 & 0x000FFFFFFFFFFFFF) | 0x3FE0000000000000).view(
        torch.float64)                                        # [0.5, 1)
    low = m < 0.70710678118654752440
    m = torch.where(low, m + m, m)
    e = (e - low.to(torch.int64)).to(torch.float64)
    x = m - 1.0
    big = (rational(x, x * x) + e * 1.428606820309417232121458176568e-6
           ) + e * 6.93145751953125e-1
    return torch.where(y.abs() < 0.41421356237309504880, rational(y, y2),
                       big)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv: Giles' polynomial evaluated with fused
    multiply-adds, on w = -log1p(-x^2); +-inf at +-1."""
    w = -_log1p_f32(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_W_LT_5[0]), _f32(_ERFINV_W_GE_5[0]))
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = _fma32(p, w, torch.where(lt, _f32(a), _f32(b)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _erfinv_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 erfinv (Giles' double-precision polynomials on
    w = -log1p(-x^2): w < 6.25, w < 16, else; +-inf at +-1)."""
    w = -_log1p_f64(x * -x)
    lt625, lt16 = w < 6.25, w < 16.0

    def coef(i):
        c = torch.full_like(x, _ERFINV64_W_LT_625[i])
        if i < len(_ERFINV64_W_LT_16):
            c = torch.where(lt625, c, _ERFINV64_W_LT_16[i])
        if i < len(_ERFINV64_W_GE_16):
            c = torch.where(lt16, c, _ERFINV64_W_GE_16[i])
        return c

    w = torch.where(lt625, w - 3.125,
                    torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))
    p = coef(0)
    for i in range(1, len(_ERFINV64_W_GE_16)):
        p = coef(i) + p * w
    for i in range(len(_ERFINV64_W_GE_16), len(_ERFINV64_W_LT_16)):
        p = torch.where(lt16, coef(i) + p * w, p)
    for i in range(len(_ERFINV64_W_LT_16), len(_ERFINV64_W_LT_625)):
        p = torch.where(lt625, coef(i) + p * w, p)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_of_words(a, b, dtype):
    """Standard normals from the two threefry words of each element, as
    ``jax.random.normal`` forms them in ``dtype``."""
    if dtype == torch.float32:
        mant = (a ^ b) >> 9                                   # 23 bits
        one = (mant | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        mant = (a << 20) | (b >> 12)                          # 52 bits
        one = (mant | 0x3FF0000000000000).view(torch.float64)
    else:
        raise TypeError(f"normal: float32 or float64, not {dtype}")
    lo = float(np.nextafter(np.array(-1.0, str(dtype)[6:]),
                            np.array(0.0, str(dtype)[6:])))
    u = torch.clamp_min((one - 1.0) * 2.0 + lo, lo)
    e = _erfinv_f32(u) if dtype == torch.float32 else _erfinv_f64(u)
    return e * math.sqrt(2.0)


def normal(k: torch.Tensor, shape=(), dtype=torch.float64) -> torch.Tensor:
    """``jax.random.normal(k, shape, dtype)`` for keys (..., 2):
    (..., *shape)."""
    a, b = _counter_words(*_flat_counters(k, shape))
    return _normal_of_words(a, b, dtype)

