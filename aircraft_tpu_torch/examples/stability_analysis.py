"""Stability analysis around trim: the continuous and discrete spectra,
the perturbation cloud, the time-step sweep and the control-surface
surface.

The default-aero glider with the CoM as a trim variable is trimmed at
50 m/s (``multistart_trim``, 64 starts); then the continuous Jacobian's
modes (``stability_eigenvalues``), the discrete step map's spectra over
25 perturbed states and a 20-point dt sweep
(``discrete_stability_analysis``), and its spectral radius over a 9 x 9
grid of aileron and elevator deflections (one batched Jacobian).

    python -m aircraft_tpu_torch.examples.stability_analysis
        [--device cuda] [--out build/aircraft_tpu_torch/stability_analysis.json]

Writes the record (``device`` holding the card's name and power limit)
to ``--out`` and, where matplotlib is installed, the three panels beside
it as a PNG.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "aircraft_tpu_torch" / "stability_analysis.json")


def run(*, n_starts=64, n_perturb=25, grid=9, seed=0, device="cuda"):
    """(record, arrays for the figure)."""
    import torch

    from aircraft_tpu_torch.bench import _card
    from aircraft_tpu_torch.config import glider_config
    from aircraft_tpu_torch.device import resolve_device
    from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
    from aircraft_tpu_torch.solvers import trim as trim_mod

    dev = resolve_device(device)
    t0 = time.perf_counter()
    params = AircraftParams.from_config(glider_config().aircraft,
                                        com_in_control=True, device=dev)
    res = trim_mod.multistart_trim(
        params, n_starts=n_starts, target_airspeed=50.0,
        generator=torch.Generator().manual_seed(seed))
    eig_c = trim_mod.stability_eigenvalues(params, res.state, res.control)
    worst = eig_c[np.argmax(eig_c.real)]
    report = trim_mod.discrete_stability_analysis(
        params, res.state, res.control, dt=0.01, n_perturb=n_perturb,
        seed=seed, device=dev)
    defl = torch.linspace(-5.0, 5.0, grid, device=dev)
    ail, ele = torch.meshgrid(defl, defl, indexing="xy")
    controls = res.control.expand(grid * grid, -1).clone()
    controls[:, 0], controls[:, 1] = ail.reshape(-1), ele.reshape(-1)
    A_grid, _ = trim_mod.discrete_jacobians(params, res.state, controls, 0.01)
    rho_grid = np.abs(np.linalg.eigvals(
        A_grid.cpu().numpy().astype(np.float64))).max(axis=-1).reshape(
            grid, grid)
    wall = time.perf_counter() - t0
    rec = {
        "experiment": "stability_analysis",
        "device": _card(dev),
        "trim_residual": float(res.residual),
        "trim_state": res.state.cpu().numpy().round(6).tolist(),
        "trim_control": res.control.cpu().numpy().round(6).tolist(),
        "continuous_max_real": float(worst.real),
        "continuous_worst_mode": [float(worst.real), float(worst.imag)],
        "continuous_neutral_modes": int(np.sum(np.abs(eig_c) < 1e-4)),
        "discrete_spectral_radius_min": float(report.spectral_radius.min()),
        "discrete_spectral_radius_max": float(report.spectral_radius.max()),
        "discrete_condition_median": float(np.median(
            report.condition_numbers)),
        "dt_sweep": report.dt_sweep.tolist(),
        "dt_spectral_radius": report.dt_spectral_radius.tolist(),
        "surface_spectral_radius_min": float(rho_grid.min()),
        "surface_spectral_radius_max": float(rho_grid.max()),
        "wall_s": round(wall, 2),
    }
    return rec, (report, rho_grid)


def _figure(path: Path, report, rho_grid) -> bool:
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(15, 5))
    ax1.add_patch(plt.Circle((0, 0), 1, color="gray", fill=False,
                             linestyle="dashed"))
    ax1.scatter(report.eigenvalues.real.ravel(),
                report.eigenvalues.imag.ravel(), s=8, alpha=0.5)
    ax1.set_xlabel("Re"), ax1.set_ylabel("Im")
    ax1.set_title("discrete eigenvalues, perturbed states")
    ax1.axis("equal"), ax1.grid(True)
    ax2.loglog(report.dt_sweep, report.dt_spectral_radius, "o-")
    ax2.axhline(1, color="r", linestyle="--")
    ax2.set_xlabel("dt"), ax2.set_ylabel("max |eig|")
    ax2.set_title("spectral radius vs timestep"), ax2.grid(True)
    im = ax3.imshow(rho_grid, origin="lower", extent=[-5, 5, -5, 5],
                    aspect="auto", cmap="viridis")
    ax3.set_xlabel("aileron"), ax3.set_ylabel("elevator")
    ax3.set_title("spectral radius vs surface deflection")
    fig.colorbar(im, ax=ax3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    return True


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--n-starts", type=int, default=64)
    p.add_argument("--n-perturb", type=int, default=25)
    a = p.parse_args(argv)
    rec, (report, rho_grid) = run(n_starts=a.n_starts,
                                  n_perturb=a.n_perturb, device=a.device)
    path = Path(a.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    if _figure(path.with_suffix(".png"), report, rho_grid):
        print(f"wrote {path.with_suffix('.png')}", file=sys.stderr)
    print(json.dumps(rec))
    print(f"wrote {path}", file=sys.stderr)


if __name__ == "__main__":
    main()
