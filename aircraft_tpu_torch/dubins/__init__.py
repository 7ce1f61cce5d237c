from aircraft_tpu_torch.dubins.dubins2d import DubinsPath, shortest_path
from aircraft_tpu_torch.dubins.dubins3d import (
    DubinsManeuver3D,
    lower_bound,
    maneuver3d,
    straight_line_fallback,
    upper_bound,
)
from aircraft_tpu_torch.dubins.vertical import VerticalCSC, vertical_profile

__all__ = [
    "DubinsPath",
    "shortest_path",
    "DubinsManeuver3D",
    "maneuver3d",
    "straight_line_fallback",
    "lower_bound",
    "upper_bound",
    "VerticalCSC",
    "vertical_profile",
]
