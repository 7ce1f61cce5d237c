"""Post-hoc trajectory dashboards and aero polars (the port of
``aircraft_tpu/plotting``); matplotlib is imported only when drawing."""

from aircraft_tpu_torch.plotting.plotting import (TrajectoryPlotter,
                                                  aero_polars,
                                                  plot_convergence,
                                                  plot_polars)

__all__ = ["TrajectoryPlotter", "plot_convergence", "aero_polars",
           "plot_polars"]
