from aircraft_tpu_torch.control.aircraft import (
    build_aircraft_ocp,
    envelope_ineq,
    goal_cost,
)

__all__ = ["build_aircraft_ocp", "envelope_ineq", "goal_cost"]
