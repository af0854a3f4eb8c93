from .interpolate import (  # noqa: F401
    BezierSpline,
    CubicHermiteSpline,
    InterpolationBase,
    LinearInterpolation,
)
