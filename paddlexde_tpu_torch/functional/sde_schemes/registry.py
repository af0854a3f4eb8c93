"""The SDE scheme registry: one table mapping a scheme name to its factory,
noise contract, calculus, strong/weak order, Brownian requirements,
adaptive controller order, option knobs and reversal class.

Counterpart of ``paddlexde_tpu/functional/sde_schemes/registry.py``, with
the whole table copied (every name, alias, noise contract, calculus, order,
Lévy need, local order, knob, ``additive_only`` and ``pathwise``), so
default-bm construction and validation match the JAX package for every
name. :data:`PORTED` holds the names whose factories run here; building any
other scheme raises ``NotImplementedError`` naming ROADMAP item 8 (their
``factory`` is None).

Field semantics (the load-bearing ones):

- ``noise``: "diagonal" (g like y, elementwise), "general" (matrix G
  [..., D, M] against an M-dim bm), "scalar" (one Brownian channel), "pair"
  (reversible_heun's (y, z) state). Decides the default-bm size and the
  time-reversal drift correction (``common._reversed_*_fns``).
- ``calculus``: "ito" | "stratonovich".
- ``levy``: what the scheme queries from the tree: "none" (ΔW),
  "space-time" ((W, I10)), "space-time-time" ((W, I10, K)), "area" (full
  Davie/Foster/Fourier A). Drives default-bm construction and explicit-bm
  validation.
- ``local_order``: the adaptive controller's default error exponent.
- ``knobs``: option keys popped from ``options`` and forwarded to the
  factory.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from .common import make_sde_term
from .explicit import (
    make_foster2_general_term,
    make_foster2_term,
    make_general_euler_term,
    make_general_milstein_term,
    make_general_sra1_term,
    make_heun_stratonovich_term,
    make_milstein_term,
    make_sra1_term,
    make_sriw1_term,
)

__all__ = ["SDESchemeSpec", "SDE_SCHEMES", "PORTED", "resolve_sde_scheme",
           "canonical_sde_scheme_names", "require_ported_scheme"]


@dataclasses.dataclass(frozen=True)
class SDESchemeSpec:
    name: str  # canonical name
    factory: Optional[Callable]  # (drift, diffusion, bm, **knobs) -> XDETerm; None: not ported
    noise: str  # "diagonal" | "general" | "scalar" | "pair"
    calculus: str  # "ito" | "stratonovich"
    strong_order: float
    weak_order: Optional[float]  # None = unmeasured (refuse in weak MC)
    levy: str  # "none" | "space-time" | "space-time-time" | "area"
    local_order: float  # adaptive controller default exponent
    aliases: Tuple[str, ...] = ()
    knobs: Tuple[str, ...] = ()  # options popped + forwarded to the factory
    factory_kwargs: Optional[dict] = None  # static kwargs (e.g. use_area)
    additive_only: bool = False
    pathwise: bool = True  # sdeint_event eligibility
    implicit: bool = False

    def build(self, drift, diffusion, bm, **knob_kw):
        require_ported_scheme(self)
        kw = dict(self.factory_kwargs or {})
        kw.update(knob_kw)
        return self.factory(drift, diffusion, bm, **kw)


_IMPLICIT_KNOBS = ("newton_iters", "krylov")

_SPECS = [
    SDESchemeSpec(
        "euler", make_sde_term, "diagonal", "ito", 0.5, 1.0, "none", 1.0,
        aliases=(),
    ),
    SDESchemeSpec(
        "milstein", make_milstein_term, "diagonal", "ito", 1.0, 1.0, "none",
        1.5,
    ),
    SDESchemeSpec(
        "implicit_em", None, "diagonal", "ito", 0.5, 1.0,
        "none", 1.0,
        aliases=("implicit_euler_maruyama", "drift_implicit_euler",
                 "stochastic_theta"),
        knobs=("theta",) + _IMPLICIT_KNOBS, implicit=True,
    ),
    SDESchemeSpec(
        "implicit_milstein", None, "diagonal", "ito",
        1.0, 1.0, "none", 1.5,
        aliases=("drift_implicit_milstein",),
        knobs=_IMPLICIT_KNOBS, implicit=True,
    ),
    SDESchemeSpec(
        "sra1", make_sra1_term, "diagonal", "ito", 1.5, 2.0, "space-time",
        2.0, additive_only=True,
    ),
    SDESchemeSpec(
        "sra1_general", make_general_sra1_term, "general", "ito", 1.5, 2.0,
        "space-time", 2.0, aliases=("general_sra1",), additive_only=True,
    ),
    SDESchemeSpec(
        "implicit_sra1", None, "diagonal", "ito", 1.5,
        2.0, "space-time", 2.0,
        aliases=("drift_implicit_sra1",), knobs=_IMPLICIT_KNOBS,
        additive_only=True, implicit=True,
    ),
    SDESchemeSpec(
        "implicit_sra1_general", None, "general",
        "ito", 1.5, 2.0, "space-time", 2.0,
        aliases=("general_implicit_sra1",), knobs=_IMPLICIT_KNOBS,
        additive_only=True, implicit=True,
    ),
    SDESchemeSpec(
        "implicit_sra1_damped", None, "diagonal",
        "ito", 1.5, 2.0, "space-time", 2.0,
        aliases=("drift_implicit_sra1_damped",), knobs=_IMPLICIT_KNOBS,
        additive_only=True, implicit=True,
    ),
    SDESchemeSpec(
        "implicit_sra1_damped_general", None,
        "general", "ito", 1.5, 2.0, "space-time", 2.0,
        aliases=("general_implicit_sra1_damped",), knobs=_IMPLICIT_KNOBS,
        additive_only=True, implicit=True,
    ),
    SDESchemeSpec(
        "sriw1", make_sriw1_term, "diagonal", "ito", 1.5, 2.0, "space-time",
        2.0,
    ),
    SDESchemeSpec(
        "heun_stratonovich", make_heun_stratonovich_term, "diagonal",
        "stratonovich", 1.0, 1.0, "none", 1.0,
        aliases=("stratonovich_heun",),
    ),
    SDESchemeSpec(
        "foster2", make_foster2_term, "diagonal", "ito", 2.0, 2.0,
        "space-time-time", 2.5, aliases=("foster",), additive_only=True,
    ),
    SDESchemeSpec(
        "foster2_general", make_foster2_general_term, "general", "ito", 2.0,
        2.0, "space-time-time", 2.5, aliases=("general_foster2",),
        additive_only=True,
    ),
    SDESchemeSpec(
        "implicit_foster2", None, "diagonal", "ito",
        2.0, 2.0, "space-time-time", 2.5,
        aliases=("drift_implicit_foster2",),
        knobs=_IMPLICIT_KNOBS + ("substeps",), additive_only=True,
        implicit=True,
    ),
    SDESchemeSpec(
        "implicit_foster2_general", None,
        "general", "ito", 2.0, 2.0, "space-time-time", 2.5,
        aliases=("general_implicit_foster2",),
        knobs=_IMPLICIT_KNOBS + ("substeps",), additive_only=True,
        implicit=True,
    ),
    SDESchemeSpec(
        "taylor15", None, "scalar", "ito", 1.5, 2.0,
        "space-time", 2.0, aliases=("ito_taylor15",),
    ),
    SDESchemeSpec(
        "taylor15_general", None, "general", "ito",
        1.5, 1.0, "area", 2.0, aliases=("general_taylor15",),
        knobs=("triple_substeps", "triple_mode"),
        factory_kwargs={"use_area": True},
    ),
    SDESchemeSpec(
        "taylor15_commutative", None, "general", "ito",
        1.5, 1.0, "space-time", 2.0, aliases=("commutative_taylor15",),
        factory_kwargs={"use_area": False},
    ),
    SDESchemeSpec(
        "weak2", None, "diagonal", "ito", 0.5, 2.0, "none", 1.5,
        aliases=("platen_weak2", "weak2_platen"), pathwise=False,
    ),
    SDESchemeSpec(
        "weak2_general", None, "general", "ito", 0.5, 2.0,
        "none", 1.5, aliases=("general_weak2",), pathwise=False,
    ),
    SDESchemeSpec(
        "euler_general", make_general_euler_term, "general", "ito", 0.5, 1.0,
        "none", 1.0, aliases=("general_euler",),
    ),
    SDESchemeSpec(
        "milstein_general", make_general_milstein_term, "general", "ito",
        1.0, 1.0, "area", 1.5, aliases=("general_milstein",),
        factory_kwargs={"use_area": True},
    ),
    SDESchemeSpec(
        "milstein_commutative", make_general_milstein_term, "general", "ito",
        1.0, 1.0, "none", 1.5, aliases=("commutative_milstein",),
        factory_kwargs={"use_area": False},
    ),
    SDESchemeSpec(
        "reversible_heun", None, "pair", "stratonovich",
        0.5, 1.0, "none", 1.0, aliases=("heun_reversible",), pathwise=False,
    ),
]

SDE_SCHEMES = {}
for _spec in _SPECS:
    SDE_SCHEMES[_spec.name] = _spec
    for _a in _spec.aliases:
        assert _a not in SDE_SCHEMES, f"duplicate scheme alias {_a!r}"
        SDE_SCHEMES[_a] = _spec

PORTED = frozenset(s.name for s in _SPECS if s.factory is not None)


def resolve_sde_scheme(name) -> Optional[SDESchemeSpec]:
    """The spec for a scheme name or alias (case-insensitive), else None:
    callers fall through to the deterministic solver registry."""
    if not isinstance(name, str):
        return None
    return SDE_SCHEMES.get(name.lower())


def canonical_sde_scheme_names():
    """Canonical names in registration order (for docs, tables, errors)."""
    return [s.name for s in _SPECS]


def require_ported_scheme(spec: SDESchemeSpec) -> None:
    """Refuse a scheme whose factory is not ported yet, by name: no name
    silently runs another scheme."""
    if spec.factory is None:
        raise NotImplementedError(
            f"SDE scheme {spec.name!r} is not ported to paddlexde_tpu_torch yet "
            f"(ROADMAP item 8: the implicit, Taylor, weak and reversible schemes come "
            f"later); ported: {sorted(PORTED)}"
        )
