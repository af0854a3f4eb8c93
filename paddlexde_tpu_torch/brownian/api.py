"""Brownian-motion API: reference-shaped classes over the virtual tree.

Counterpart of ``paddlexde_tpu/brownian/api.py``: ``BaseBrownian``,
``BrownianInterval``, ``BrownianPath``, ``BrownianTree``,
``AntitheticBrownian``, ``ReverseBrownian`` and ``brownian_interval_like``
with the call convention ``bm(ta, tb, return_U=..., return_A=...)``. The
stateful knobs of the reference (``pool_size``, ``cache_size``,
``halfway_tree``) are accepted and ignored: the stateless tree has no pools
or caches to tune.

A key is a :class:`~.prng.PRNGKey` (``prng.key_from_jax`` takes a JAX key's
words), an ``int`` (``jax.random.key(int)``'s key) or ``None`` (key 0): the
same key gives the JAX package's path. Draws land on ``device``: the
device of ``W`` when it is a tensor, else ``device=`` through
:func:`~paddlexde_tpu_torch._device.resolve_device` (the card by default).
Query times are read on the host (a read of a card tensor is a host sync;
``sdeint`` keeps its grid on the host).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from . import prng
from .virtual_tree import brownian_pair, brownian_triple, host_time, reverse_triple, tol_to_depth

__all__ = [
    "BaseBrownian",
    "BrownianInterval",
    "BrownianPath",
    "BrownianTree",
    "ReverseBrownian",
    "AntitheticBrownian",
    "brownian_interval_like",
    "LEVY_AREA_APPROXIMATIONS",
]


class LEVY_AREA_APPROXIMATIONS:
    """The Lévy-area modes: ``space_time_time`` gives the (W, U, K) triple
    descent; ``fourier`` the bridge's Fourier expansion with an
    exact-variance tail."""

    none = "none"
    space_time = "space-time"
    space_time_time = "space-time-time"
    davie = "davie"
    foster = "foster"
    fourier = "fourier"


_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype).name]


class BaseBrownian:
    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        raise NotImplementedError

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def levy_area_approximation(self):
        return self._levy


class BrownianInterval(BaseBrownian):
    """W over [t0, t1] with optional space-time and full Lévy areas.

    ``entropy`` (or ``key=``) is an int, a :class:`~.prng.PRNGKey` or None.
    A float32 and a float64 interval with one key are different paths (JAX
    draws a float32 normal from 32 random bits and a float64 one from 64).
    The leading rows of a batch are the path of a smaller batch with the
    same key: ``size=(n, d)`` restricted to its first ``r`` rows equals
    ``size=(r, d)``.

    .. warning:: the domain ``[t0, t1]`` must COVER every query: the tree
       clips out-of-domain times to the boundary, so ``W`` freezes there
       while interval formulas keep using the unclipped ``tb - ta``; the
       returned (W, U, K) triple turns mutually inconsistent and schemes
       integrate a bogus constant forcing. ``sdeint``'s default bm derives
       its bounds from ``t_span``; only explicitly-constructed intervals
       can be mis-sized.

    .. note:: ``levy_area_approximation`` changes WHICH path the key
       generates, not just what is returned: the joint (W, U[, K]) descent
       consumes the node streams differently from the plain-W bisection, so
       two intervals sharing a key but differing in mode produce DIFFERENT
       (equal-in-law) paths. To couple schemes pathwise, share ONE bm
       object, or at least one mode, across all of them.
    """

    def __init__(
        self,
        t0,
        t1,
        size: Tuple[int, ...] = (),
        dtype=torch.float32,
        entropy=None,
        *,
        key=None,
        dt=None,
        tol: Optional[float] = None,
        pool_size: int = 8,
        cache_size: int = 45,
        halfway_tree: bool = False,
        levy_area_approximation: str = LEVY_AREA_APPROXIMATIONS.none,
        W=None,
        H=None,
        levy_fourier_terms: int = 8,
        device=None,
    ):
        del dt, pool_size, cache_size, halfway_tree, H  # stateless: no-ops
        self._t0 = t0
        self._t1 = t1
        self._shape = tuple(int(s) for s in size)
        self._dtype = _torch_dtype(dtype)
        self._key = prng.as_key(key if key is not None else entropy)
        self._depth = tol_to_depth(float(host_time(t0)), float(host_time(t1)), tol)
        self._levy = levy_area_approximation
        self._fourier_terms = int(levy_fourier_terms)
        if device is None and isinstance(W, torch.Tensor):
            self._device = W.device
        else:
            self._device = resolve_device(device)
        self._w_total = None if W is None else torch.as_tensor(W, dtype=self._dtype,
                                                                device=self._device)

    @property
    def interval(self):
        return (self._t0, self._t1)

    @property
    def device(self) -> torch.device:
        return self._device

    def _pair(self, ta, tb, levy, triple=False):
        return brownian_pair(
            self._key, self._t0, self._t1, ta, tb, self._shape, self._dtype,
            self._depth, self._w_total, levy=levy, fourier_terms=self._fourier_terms,
            triple=triple, device=self._device,
        )

    def __call__(self, ta, tb=None, return_U=False, return_A=False,
                 return_K=False, return_J3=False):
        if tb is None:
            ta, tb = self._t0, ta  # reference: single arg means W(t0, ta)
        if return_J3:
            # joint (W, U, A, J3): the exact level-<=3 signature of the
            # truncated bridge path; take A and J3 both from this query
            if self._levy != LEVY_AREA_APPROXIMATIONS.fourier:
                raise ValueError(
                    "return_J3 (level-3 iterated integrals) requires "
                    "levy_area_approximation='fourier' (the truncated-KL "
                    f"path construction); got {self._levy!r}"
                )
            if not (return_U and return_A):
                raise ValueError(
                    "return_J3 is a joint query: pass return_U=True and "
                    "return_A=True (the scheme needs the consistent 4-tuple)"
                )
            return self._pair(ta, tb, "fourier", triple=True)
        if self._levy == LEVY_AREA_APPROXIMATIONS.space_time_time:
            # every query of a K-configured interval goes through the
            # (W, U, V) descent, so W and U agree across query modes
            if return_A:
                raise ValueError(
                    "full Lévy area is not available from the space-time-time "
                    "tree; construct with 'davie', 'foster' or 'fourier'."
                )
            w, u, k = brownian_triple(
                self._key, self._t0, self._t1, ta, tb, self._shape, self._dtype,
                self._depth, self._w_total, device=self._device,
            )
            if return_K:
                return w, u, k
            if return_U:
                return w, u
            return w
        if return_K:
            raise ValueError(
                "return_K requires levy_area_approximation='space-time-time'"
            )
        if return_A and self._levy in ("none", "space-time"):
            raise ValueError(
                f"Lévy area requested but levy_area_approximation={self._levy!r}; "
                f"construct with 'davie', 'foster' or 'fourier'."
            )
        if return_U and self._levy == "none":
            raise ValueError(
                "space-time Lévy area requested but levy_area_approximation='none'"
            )
        # a Lévy-configured interval routes every query through the joint
        # (W, U) descent so W is the same in every query mode; the area is
        # drawn from its own per-query key only when asked for
        levy_mode = self._levy if return_A else (
            "space-time" if self._levy != "none" else "none"
        )
        w, u, a = self._pair(ta, tb, levy_mode)
        if return_U and return_A:
            return w, u, a
        if return_U:
            return w, u
        if return_A:
            return w, a
        return w


class BrownianPath(BrownianInterval):
    """An interval with unbounded cache in the reference: here the same
    BrownianInterval (the stateless tree has no cache)."""

    def __init__(self, t0, w0=None, t1=None, size=None, **kwargs):
        if size is None and w0 is not None:
            size = tuple(torch.as_tensor(w0).shape)
        super().__init__(t0, t1 if t1 is not None else t0 + 1.0, size or (), **kwargs)
        self._w0 = None if w0 is None else torch.as_tensor(w0, device=self._device)

    def __call__(self, ta, tb=None, return_U=False, return_A=False):
        out = super().__call__(ta, tb, return_U, return_A)
        if self._w0 is not None and tb is None and not (return_U or return_A):
            return out + self._w0
        return out


class BrownianTree(BrownianInterval):
    """Tol-controlled, query-order-independent sample paths: properties the
    stateless tree has natively."""

    def __init__(self, t0, w0=None, t1=None, entropy=None, tol=2**-12, **kwargs):
        size = kwargs.pop("size", None)
        if size is None and w0 is not None:
            size = tuple(torch.as_tensor(w0).shape)
        super().__init__(
            t0,
            t1 if t1 is not None else t0 + 1.0,
            size or (),
            entropy=entropy,
            tol=tol,
            **kwargs,
        )
        self._w0 = None if w0 is None else torch.as_tensor(w0, device=self._device)


def _negate(out):
    return tuple(-x for x in out) if isinstance(out, tuple) else -out


class AntitheticBrownian(BaseBrownian):
    """The pathwise-negated driving noise W~ = -W for antithetic Monte
    Carlo: dW~ = -dW, U~ = -U, K~ = -K, A~ = +A (the area is bilinear in
    the path), J3~ = -J3. ``base_brownian`` exposes the wrapped tree."""

    def __init__(self, base_brownian: BaseBrownian):
        if getattr(base_brownian, "_w0", None) is not None:
            raise ValueError(
                "AntitheticBrownian negates INCREMENTS; a w0-offset "
                "BrownianPath/BrownianTree's single-arg value queries would "
                "negate the offset too — wrap the zero-offset interval and "
                "add w0 yourself"
            )
        self.base_brownian = base_brownian
        self._shape = base_brownian.shape
        self._dtype = base_brownian.dtype
        self._levy = base_brownian.levy_area_approximation

    def __call__(self, ta, tb=None, return_U=False, return_A=False,
                 return_K=False, return_J3=False):
        kw = {}
        if return_U:
            kw["return_U"] = True
        if return_A:
            kw["return_A"] = True
        if return_K:
            kw["return_K"] = True
        if return_J3:
            kw["return_J3"] = True
        out = self.base_brownian(ta, tb, **kw)
        if not (return_U or return_A or return_K or return_J3):
            return _negate(out)
        res = [-out[0]]
        pos = 1
        if return_U or return_K:  # the tree returns U whenever K is asked
            res.append(-out[pos])
            pos += 1
        if return_K:
            res.append(-out[pos])
            pos += 1
        if return_A:
            res.append(out[pos])  # +A (bilinear)
            pos += 1
        if return_J3:
            res.append(-out[pos])  # odd degree
        return tuple(res)


def _span(ta, tb) -> float:
    return float(host_time(tb) - host_time(ta))


class ReverseBrownian(BaseBrownian):
    """Negated query times for backward SDE solves: W~(s) = W(-s). Per
    query over [sa, sb] (forward [ta, tb] = [-sb, -sa], h = sb - sa):
    dW~ = -dW, U~ = U - h dW (so H~ = H), K~ = h U - K - h^2 dW / 2,
    A~ = -A, and the level-3 signature is the group inverse
    (:func:`~.virtual_tree.reverse_triple`)."""

    def __init__(self, base_brownian: BaseBrownian):
        self.base_brownian = base_brownian
        self._shape = base_brownian.shape
        self._dtype = base_brownian.dtype
        self._levy = base_brownian.levy_area_approximation

    def __call__(self, ta, tb=None, return_U=False, return_A=False,
                 return_K=False, return_J3=False):
        if tb is None:
            raise ValueError("ReverseBrownian requires both ta and tb")
        h = _span(ta, tb)
        if return_J3:
            w, u, a, j3 = self.base_brownian(-tb, -ta, return_U=True, return_A=True,
                                             return_J3=True)
            a_r, j3_r = reverse_triple(w, a, j3)
            return -w, u - h * w, a_r, j3_r
        if return_K:
            w, u, k = self.base_brownian(-tb, -ta, return_U=True, return_K=True)
            return -w, u - h * w, h * u - k - 0.5 * h**2 * w
        out = self.base_brownian(-tb, -ta, return_U=return_U, return_A=return_A)
        if not (return_U or return_A):
            return -out
        w = out[0]
        res = [-w]
        if return_U:
            res.append(out[1] - h * w)
        if return_A:
            res.append(-out[-1])
        return tuple(res)


def brownian_interval_like(y, t0=0.0, t1=1.0, **kwargs):
    """A BrownianInterval with ``y``'s shape, dtype and device."""
    y = torch.as_tensor(y)
    kwargs.setdefault("size", tuple(y.shape))
    kwargs.setdefault("dtype", y.dtype)
    kwargs.setdefault("device", y.device)
    return BrownianInterval(t0, t1, **kwargs)
