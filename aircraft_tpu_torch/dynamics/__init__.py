from aircraft_tpu_torch.dynamics.base import (
    STATE_DIM,
    control_dim,
    state_derivative,
)
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.dynamics.quadrotor import QuadrotorParams
from aircraft_tpu_torch.dynamics.coefficients import (
    COEFF_MODEL_REGISTRY,
    DefaultCoeffParams,
    LinearCoeffParams,
    MLPCoeffParams,
    PolyCoeffParams,
)

__all__ = [
    "STATE_DIM",
    "state_derivative",
    "control_dim",
    "AircraftParams",
    "QuadrotorParams",
    "COEFF_MODEL_REGISTRY",
    "DefaultCoeffParams",
    "LinearCoeffParams",
    "MLPCoeffParams",
    "PolyCoeffParams",
]
