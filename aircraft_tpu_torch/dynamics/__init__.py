from aircraft_tpu_torch.dynamics.aircraft import AircraftParams, state_derivative
from aircraft_tpu_torch.dynamics.coefficients import (
    COEFF_MODEL_REGISTRY,
    DefaultCoeffParams,
    LinearCoeffParams,
    MLPCoeffParams,
    PolyCoeffParams,
)

__all__ = [
    "state_derivative",
    "AircraftParams",
    "COEFF_MODEL_REGISTRY",
    "DefaultCoeffParams",
    "LinearCoeffParams",
    "MLPCoeffParams",
    "PolyCoeffParams",
]
