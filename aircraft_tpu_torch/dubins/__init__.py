from aircraft_tpu_torch.dubins.dubins2d import DubinsPath, shortest_path
from aircraft_tpu_torch.dubins.dubins3d import DubinsManeuver3D, maneuver3d, straight_line_fallback

__all__ = [
    "DubinsPath",
    "shortest_path",
    "DubinsManeuver3D",
    "maneuver3d",
    "straight_line_fallback",
]
