from .functional import cubic_hermite_interp, fill_forward, linear_interp  # noqa: F401
from .interpolate import (  # noqa: F401
    BezierSpline,
    CubicHermiteSpline,
    InterpolationBase,
    LinearInterpolation,
    NaturalCubicSpline,
    rectilinear_interpolation,
)
