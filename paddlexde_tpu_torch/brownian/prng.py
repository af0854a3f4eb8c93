"""A threefry-2x32 counter-based PRNG whose bits equal JAX's.

Counterpart of ``jax.random`` as the JAX package's Brownian tree uses it:
``key``, ``fold_in``, ``split``, ``random_bits``, ``uniform`` and
``normal``, on the threefry-2x32 hash with JAX's key schedule and rotations
(``jax/_src/prng.py``: ``threefry_seed``, ``_threefry2x32_lowering``,
``threefry_fold_in``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``). JAX runs with
``jax_threefry_partitionable`` on (the default since JAX 0.5), so the
partitionable forms are the ones matched: the counters of a draw of shape
``S`` are the 64-bit row-major index of each element split into ``(hi,
lo)`` words, a 32-bit draw is ``bits1 ^ bits2`` and a 64-bit draw ``bits1 <<
32 | bits2``; ``split`` hashes the counters ``(0, i)``.

Keys live on the host (:class:`PRNGKey`, two uint32 words): ``fold_in`` and
``split`` of host keys are numpy (uint32 arithmetic wraps). A draw hashes
its counters on the tensor's device in ``int64`` holding uint32 values,
masked after every add and shift (PyTorch has no uint32 ``add`` or shifts
on the CPU), for one key or for a batch of keys at once
(:func:`normal_rows`, one row per key: the Brownian tree draws all the
nodes of a query in one call).

The normal is JAX's: a uniform on ``[nextafter(-1, 0), 1)`` from the
mantissa bits, then ``sqrt(2) * erf_inv(u)`` with XLA's polynomial
``erf_inv`` (Giles' single-precision form for float32, the three-branch
double-precision form for float64, coefficients as XLA's compiled
``chlo.erf_inv`` holds them) on XLA's float64 ``log1p``. ``torch.erfinv``
is not that function (it differs by up to 1.5e-5 in float32 near +-1).
What remains is rounding: ``log1p`` (float32: PyTorch's against XLA's own;
float64: XLA contracts its polynomials into FMAs) and the FMA contraction
of the ``erf_inv`` polynomial move some normals by a few ulps
(tests/test_torch_brownian.py states the bound); the keys, the raw bits and
the uniforms are equal bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..utils.misc import to_device

__all__ = [
    "PRNGKey",
    "key",
    "key_from_jax",
    "as_key",
    "fold_in",
    "fold_in_many",
    "split",
    "threefry2x32",
    "random_bits",
    "uniform",
    "normal",
    "normal_rows",
    "erf_inv",
]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


class PRNGKey:
    """A threefry key: two uint32 words on the host (``data``, shape [2]),
    the same words as ``jax.random.key_data`` of the JAX key."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = np.asarray(data, dtype=np.uint32).reshape(2)

    def __repr__(self):
        return f"PRNGKey([{int(self.data[0])}, {int(self.data[1])}])"

    def __eq__(self, other):
        return isinstance(other, PRNGKey) and bool((self.data == other.data).all())

    def __hash__(self):
        return hash((int(self.data[0]), int(self.data[1])))


def key(seed: int) -> PRNGKey:
    """``jax.random.key(seed)`` (x64 semantics: a 64-bit seed becomes
    ``[seed >> 32, seed & 0xFFFFFFFF]``)."""
    seed = int(seed)
    return PRNGKey([(seed >> 32) & _MASK, seed & _MASK])


def key_from_jax(key_data) -> PRNGKey:
    """The key whose words are ``np.asarray(jax.random.key_data(k))``."""
    data = np.asarray(key_data)
    if data.shape != (2,):
        raise ValueError(f"a threefry key has two uint32 words, got shape {data.shape}")
    return PRNGKey(data.astype(np.uint32))


def as_key(entropy_or_key) -> PRNGKey:
    """``None`` -> key 0, an ``int`` -> :func:`key`, a :class:`PRNGKey` as
    is, two words (numpy) -> :func:`key_from_jax`."""
    if entropy_or_key is None:
        return key(0)
    if isinstance(entropy_or_key, PRNGKey):
        return entropy_or_key
    if isinstance(entropy_or_key, (int, np.integer)):
        return key(int(entropy_or_key))
    return key_from_jax(entropy_or_key)


def _threefry_np(k1, k2, x0, x1):
    """The threefry-2x32 hash on uint32 numpy arrays (broadcast)."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    x0, x1 = np.asarray(x0, np.uint32), np.asarray(x1, np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(_PARITY))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x0 ^ x1
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def fold_in(k: PRNGKey, data: int) -> PRNGKey:
    """``jax.random.fold_in(k, data)``: the hash of the counters ``(0,
    data mod 2**32)`` under ``k``."""
    out = fold_in_many(k.data[None], np.asarray([int(data) & _MASK], np.uint64))
    return PRNGKey(out[0])


def fold_in_many(keys: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Row ``r`` is ``fold_in(keys[r], data[r])``: keys [R, 2] uint32, data
    [R] (taken mod 2**32) -> [R, 2] uint32."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    words = (np.asarray(data).astype(np.int64) & _MASK).astype(np.uint32)
    x0, x1 = _threefry_np(keys[:, 0], keys[:, 1], np.zeros_like(words), words)
    return np.stack([x0, x1], axis=-1)


def split(k: PRNGKey, num: int = 2) -> list:
    """``jax.random.split(k, num)`` (partitionable): key ``i`` is the hash
    of the counters ``(0, i)``."""
    idx = np.arange(num, dtype=np.uint32)
    x0, x1 = _threefry_np(k.data[0], k.data[1], np.zeros_like(idx), idx)
    return [PRNGKey([a, b]) for a, b in zip(x0, x1)]


def _upload(words: np.ndarray, device: torch.device) -> torch.Tensor:
    return to_device(np.asarray(words, dtype=np.int64), device)


def threefry2x32(k1, k2, x0, x1):
    """The threefry-2x32 hash on ``int64`` tensors holding uint32 values
    (keys may be Python ints or tensors; everything broadcasts)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & _MASK
    return x0, x1


def _hash_rows(keys, shape, device: torch.device):
    """(bits1, bits2) [R, n] of a draw of ``shape`` under each of R keys
    (``keys``: [R, 2] uint32 words, numpy, or an int64 tensor on
    ``device``). The counters are the flat indices 0..n-1, so the first
    rows of a draw are a smaller draw of those rows under the same key."""
    if isinstance(keys, np.ndarray):
        keys = _upload(keys.reshape(-1, 2), device)
    n_total = int(np.prod(shape, dtype=np.int64))
    if n_total >= 2**32:
        raise NotImplementedError("draws of 2**32 elements or more")
    lo = torch.arange(n_total, dtype=torch.int64, device=device)
    return threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)


def random_bits(k: PRNGKey, bit_width: int, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.bits``: 32-bit words as int64 (uint32 values); 64-bit
    words as int64 (the uint64 bit pattern, two's complement)."""
    shape = tuple(int(s) for s in shape)
    b1, b2 = _hash_rows(k.data[None], shape, torch.device(device))
    if bit_width == 32:
        return (b1 ^ b2)[0].reshape(shape)
    if bit_width == 64:
        return ((b1 << 32) | b2)[0].reshape(shape)
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _unit_floats(b1, b2, dtype):
    """Floats in [0, 1) from the hash words, as JAX's ``_uniform`` makes
    them: the top mantissa bits under the exponent of 1.0, minus 1."""
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        # (b1 << 32 | b2) >> 12 without leaving int64's positive range
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise TypeError(f"uniform/normal support float32 and float64, got {dtype}")


def _scale_uniform(floats, lo: float, hi: float, dtype):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo_c, hi_c = np_dtype(lo), np_dtype(hi)
    span = float(hi_c - lo_c)  # in the dtype, as JAX's lax ops
    return torch.clamp_min(floats * span + float(lo_c), float(lo_c))


def uniform(k: PRNGKey, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(k, shape, dtype, minval, maxval)``."""
    shape = tuple(int(s) for s in shape)
    b1, b2 = _hash_rows(k.data[None], shape, torch.device(device))
    return _scale_uniform(_unit_floats(b1, b2, dtype), minval, maxval, dtype)[0].reshape(shape)


def _normal_from_words(b1, b2, dtype):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(np_dtype(-1.0), np_dtype(0.0)))
    u = _scale_uniform(_unit_floats(b1, b2, dtype), lo, 1.0, dtype)
    return erf_inv(u) * float(np_dtype(np.sqrt(2)))


def normal(k: PRNGKey, shape=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``jax.random.normal(k, shape, dtype)``."""
    return normal_rows(k.data[None], shape, dtype, device)[0]


def normal_rows(keys, shape=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    """[R, *shape]: row ``r`` is ``jax.random.normal(keys[r], shape, dtype)``
    -- one batched hash for all the keys. ``keys``: [R, 2] uint32 words
    (numpy), a list of :class:`PRNGKey`, or an int64 tensor of the words
    on ``device``."""
    if isinstance(keys, (list, tuple)):
        keys = np.stack([kk.data for kk in keys])
    shape = tuple(int(s) for s in shape)
    device = torch.device(device)
    b1, b2 = _hash_rows(keys, shape, device)
    return _normal_from_words(b1, b2, dtype).reshape((b1.shape[0],) + shape)


# XLA's erf_inv (the chlo decomposition), coefficients highest power first
_ERFINV_F32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),  # w < 5
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),  # w >= 5
)
_ERFINV_F64_LT625 = (
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
    6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
    1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.006033670871430149,
    0.24015818242558962, 1.6536545626831027,
)
_ERFINV_F64_LT16 = (
    2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
    0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
    -0.003751208507569241, 0.005370914553590064, 1.0052589676941592,
    3.0838856104922208,
)
_ERFINV_F64_GE16 = (
    -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
    7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.849906401408584,
)


_TABLES: dict = {}


def _erfinv_table(dtype, device) -> torch.Tensor:
    """The coefficient rows of one dtype on one device, made once (a copy
    to the card at every call would cost a host sync each)."""
    cache_key = (dtype, str(device))
    if cache_key not in _TABLES:
        if dtype == torch.float32:
            rows = np.asarray(_ERFINV_F32, np.float32)
        else:
            rows = np.zeros((3, 23))
            rows[0] = _ERFINV_F64_LT625
            rows[1, :19] = _ERFINV_F64_LT16
            rows[2, :17] = _ERFINV_F64_GE16
        _TABLES[cache_key] = torch.from_numpy(rows).to(device)
    return _TABLES[cache_key]


# XLA's float64 log1p below |x| < sqrt(2) - 1: Cephes' rational form
# x - x^2/2 + x^3 P(x)/Q(x), coefficients highest power first
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_f64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``log1p``: the Cephes rational form for |x| < sqrt(2)
    - 1 and ``log(1 + x)`` beyond. It is up to 128 ulps from the correctly
    rounded value near x = -0.414 (the rational form is Cephes' for
    [-0.29, 0.41]); ``torch.log1p`` would sit those 128 ulps away from JAX.
    This form stays within an ulp of XLA's (XLA contracts the polynomial
    into FMAs)."""
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for c in _LOG1P_P:
        num = num * x + c
    for c in _LOG1P_Q:
        den = den * x + c
    x2 = x * x
    small = x + (-0.5 * x2 + x * (x2 * (num / den)))
    return torch.where(x.abs() < 0.41421356237309504880, small, torch.log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``erf_inv`` in float32 or float64 (module docstring)."""
    neg_sq = x * -x
    w = -(_log1p_f64(neg_sq) if x.dtype == torch.float64 else torch.log1p(neg_sq))
    if x.dtype == torch.float32:
        lt = w < 5.0
        z = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        # rows: the coefficient of each power for w < 5 and w >= 5
        c = _erfinv_table(x.dtype, x.device)[torch.where(lt, 0, 1)]  # [..., 9]
        p = c[..., 0]
        for i in range(1, 9):
            p = c[..., i] + p * z
    elif x.dtype == torch.float64:
        lt625, lt16 = w < 6.25, w < 16.0
        z = torch.where(lt625, w - 3.125, torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))
        # one row of 23 coefficients per branch; the shorter polynomials of
        # the w >= 6.25 branches start at their own first power
        branch = torch.where(lt625, 0, torch.where(lt16, 1, 2))
        c = _erfinv_table(x.dtype, x.device)[branch]  # [..., 23]
        p = c[..., 0]
        for i in range(1, 17):
            p = c[..., i] + p * z
        for i in range(17, 19):
            p = torch.where(lt16, c[..., i] + p * z, p)
        for i in range(19, 23):
            p = torch.where(lt625, c[..., i] + p * z, p)
    else:
        raise TypeError(f"erf_inv supports float32 and float64, got {x.dtype}")
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)
