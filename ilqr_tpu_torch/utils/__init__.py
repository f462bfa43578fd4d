from ilqr_tpu_torch.utils.refline import ReferenceLine, RoutingLine
from ilqr_tpu_torch.utils.splines import CubicSpline1D, CubicSpline2D
from ilqr_tpu_torch.utils.timing import TicToc

__all__ = [
    "CubicSpline1D",
    "CubicSpline2D",
    "ReferenceLine",
    "RoutingLine",
    "TicToc",
]
