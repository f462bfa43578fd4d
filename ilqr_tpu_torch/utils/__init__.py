from ilqr_tpu_torch.utils.refline import ReferenceLine, RoutingLine
from ilqr_tpu_torch.utils.splines import CubicSpline1D, CubicSpline2D, calc_spline_course
from ilqr_tpu_torch.utils.timing import TicToc

__all__ = [
    "CubicSpline1D",
    "CubicSpline2D",
    "calc_spline_course",
    "ReferenceLine",
    "RoutingLine",
    "TicToc",
]
