from aircraft_tpu_torch.surrogates.models import (
    fit_linear,
    fit_polynomial,
    load_aero_csv,
    load_mlp,
    save_mlp,
    train_mlp,
    weighted_mse,
)

__all__ = [
    "fit_linear",
    "fit_polynomial",
    "load_aero_csv",
    "train_mlp",
    "weighted_mse",
    "save_mlp",
    "load_mlp",
]
