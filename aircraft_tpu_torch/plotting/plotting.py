"""Host-side trajectory visualisation, never on the solve path.

The numbers and the drawing are kept apart.  The numbers behind the
panels are computed in torch, batched over the whole trajectory, on the
parameters' device, and come back as numpy: the plant's own α / β,
body-frame forces and moments (``TrajectoryPlotter._plant_panels``), the
Euler angles (``_euler``), the attitude quivers and the aero polars
(``aero_polars``).  The drawing is matplotlib on those arrays, imported
only inside the drawing methods, with the Agg backend.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from aircraft_tpu_torch.device import resolve_device
from aircraft_tpu_torch.ops import quaternion as quat
from aircraft_tpu_torch.utils import TrajectoryData


def _on(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _euler(states: np.ndarray, device="cuda") -> np.ndarray:
    """ZYX Euler angles (T, 3) of the states' quaternions."""
    with torch.no_grad():
        return _host(quat.to_euler(_on(states[:, 6:10],
                                       resolve_device(device))))


def _body_x(states: np.ndarray, device="cuda") -> np.ndarray:
    """The body x-axis in NED (T, 3) of the states' quaternions."""
    dev = resolve_device(device)
    q = _on(states[:, 6:10], dev)
    with torch.no_grad():
        return _host(quat.rotate(q, torch.tensor(
            [1.0, 0.0, 0.0], device=dev).expand(q.shape[0], 3)))


def plot_convergence(ax, inf_pr, inf_du):
    """Primal and dual infeasibility against the iteration."""
    ax.plot(inf_pr, label="primal inf")
    ax.plot(inf_du, label="dual inf")
    ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.legend()
    return ax


class TrajectoryPlotter:
    """Dashboard over a ``TrajectoryData``: the 3D path with body-axis
    quivers and waypoints, attitude, velocity, body rates, altitude or
    waypoint progress, surfaces, and the aero panel.

    With ``params`` (an ``AircraftParams``) the aero panel shows the
    plant's own α / β (``aero_state`` over the flown states and controls,
    wind-aware with ``wind``) and two more panels the body-frame forces
    and moments (``forces_frd`` / ``moments_frd``).  Without params it
    falls back to the inertial-velocity approximation (wrong under wind,
    and labelled so).  The numbers run on ``device``: the parameters'
    device by default, else ``cuda``."""

    def __init__(self, waypoints: Optional[np.ndarray] = None, dt: float = 0.01,
                 params=None, wind=None, device=None):
        self.waypoints = waypoints
        self.dt = dt
        self.params = params
        self.wind = wind
        self.device = resolve_device(
            device if device is not None
            else params.device if params is not None else "cuda")

    def _plant_panels(self, xs: np.ndarray, us: Optional[np.ndarray]):
        """(alpha, beta, forces, moments) of the flown knots from the
        plant's own functions, one batched call each; None without params
        or controls."""
        if self.params is None or us is None or us.shape[0] == 0:
            return None
        from aircraft_tpu_torch.dynamics import aircraft as ac

        dev = self.device
        params = self.params if self.params.device == dev else self.params.to(dev)
        n = min(xs.shape[0], us.shape[0])
        x = _on(xs[:n, :13], dev)
        u = _on(us[:n, :7], dev)
        wind = None if self.wind is None else _on(self.wind, dev)
        with torch.no_grad():
            aero = ac.aero_state(params, x, u, wind)
            F, M = ac.forces_moments(params, x, u, wind)
        return _host(aero.alpha), _host(aero.beta), _host(F), _host(M)

    def plot(self, data: TrajectoryData, show: bool = False):
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        xs = np.asarray(data.state)
        us = np.asarray(data.control) if data.control is not None else None
        T = xs.shape[0]
        t = np.arange(T) * self.dt if data.time is None else np.asarray(data.time)
        if np.ndim(t) == 0 or len(np.atleast_1d(t)) != T:
            t = np.arange(T) * self.dt

        fig = plt.figure(figsize=(18, 10))

        ax3d = fig.add_subplot(3, 4, (1, 6), projection="3d")
        ax3d.plot(xs[:, 0], xs[:, 1], -xs[:, 2], "b-", lw=1)
        # body x-axis quivers at about 25 samples
        idx = np.arange(0, T, max(1, T // 25))
        fwd = _body_x(xs[idx], self.device)
        ax3d.quiver(xs[idx, 0], xs[idx, 1], -xs[idx, 2],
                    fwd[:, 0], fwd[:, 1], -fwd[:, 2],
                    length=8.0, color="r", normalize=True)
        if self.waypoints is not None:
            w = np.asarray(self.waypoints)
            ax3d.scatter(w[:, 0], w[:, 1], -w[:, 2], c="g", s=60, marker="o")
        ax3d.set_xlabel("N [m]"); ax3d.set_ylabel("E [m]"); ax3d.set_zlabel("alt [m]")
        ax3d.set_title("trajectory")

        eul = _euler(xs, self.device)
        ax = fig.add_subplot(3, 4, 3)
        for i, n in enumerate(["phi", "theta", "psi"]):
            ax.plot(t, np.rad2deg(eul[:, i]), label=n)
        ax.legend(); ax.set_title("attitude [deg]")

        ax = fig.add_subplot(3, 4, 4)
        for i, n in enumerate(["vx", "vy", "vz"]):
            ax.plot(t, xs[:, 3 + i], label=n)
        ax.plot(t, np.linalg.norm(xs[:, 3:6], axis=1), "k--", label="|v|")
        ax.legend(); ax.set_title("velocity [m/s]")

        ax = fig.add_subplot(3, 4, 7)
        for i, n in enumerate(["p", "q", "r"]):
            ax.plot(t, xs[:, 10 + i], label=n)
        ax.legend(); ax.set_title("body rates [rad/s]")

        plant = self._plant_panels(xs, us)

        ax = fig.add_subplot(3, 4, 8)
        if plant is not None and data.lam is not None:
            # the force and moment panels take slots 10 and 12: progress
            # takes the altitude slot (altitude reads off the 3D plot)
            lam = np.asarray(data.lam)
            for j in range(lam.shape[1]):
                ax.plot(lam[:, j], label=f"λ{j}")
            ax.legend(); ax.set_title("waypoint progress")
        else:
            ax.plot(t, -xs[:, 2])
            ax.set_title("altitude [m]")

        if us is not None and us.shape[0] > 0:
            tu = t[: us.shape[0]]
            ax = fig.add_subplot(3, 4, 9)
            for i, n in enumerate(["aileron", "elevator", "rudder"]):
                ax.plot(tu, us[:, i], label=n)
            if us.shape[1] > 6:
                ax.plot(tu, us[:, 6], label="flaps")
            ax.legend(); ax.set_title("surfaces")

        ax = fig.add_subplot(3, 4, 11)
        speed = np.linalg.norm(xs[:, 3:6], axis=1)
        if plant is not None:
            alpha, beta, F, M = plant
            ta = t[: alpha.shape[0]]
            ax.plot(ta, np.rad2deg(alpha), label="alpha")
            ax.plot(ta, np.rad2deg(beta), label="beta")
            ax.plot(t, speed, label="|v|")
            ax.legend(); ax.set_title("aero (plant, wind-aware) [deg, m/s]")

            ax = fig.add_subplot(3, 4, 10)
            for i, n in enumerate(["Fx", "Fy", "Fz"]):
                ax.plot(ta, F[:, i], label=n)
            ax.legend(); ax.set_title("forces FRD [N]")
            ax = fig.add_subplot(3, 4, 12)
            for i, n in enumerate(["Mx", "My", "Mz"]):
                ax.plot(ta, M[:, i], label=n)
            ax.legend(); ax.set_title("moments FRD [N·m]")
        else:
            alpha = np.arctan2(xs[:, 5], np.maximum(xs[:, 3], 1e-6))
            ax.plot(t, np.rad2deg(alpha), label="alpha*")
            ax.plot(t, speed, label="|v|")
            ax.legend(); ax.set_title("aero (inertial approx)")

        if data.lam is not None and plant is None:
            ax = fig.add_subplot(3, 4, 12)
            lam = np.asarray(data.lam)
            for j in range(lam.shape[1]):
                ax.plot(lam[:, j], label=f"λ{j}")
            ax.legend(); ax.set_title("waypoint progress")

        fig.tight_layout()
        if show:
            plt.show()
        return fig

    def save(self, data: TrajectoryData, path) -> None:
        fig = self.plot(data)
        fig.savefig(path, dpi=110)
        import matplotlib.pyplot as plt

        plt.close(fig)

    def animation(self, data: TrajectoryData, path, fps: int = 20) -> None:
        """GIF of the 3D trajectory."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation, PillowWriter

        xs = np.asarray(data.state)
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        (line,) = ax.plot([], [], [], "b-")
        (dot,) = ax.plot([], [], [], "ro")
        ax.set_xlim(xs[:, 0].min() - 5, xs[:, 0].max() + 5)
        ax.set_ylim(xs[:, 1].min() - 5, xs[:, 1].max() + 5)
        ax.set_zlim((-xs[:, 2]).min() - 5, (-xs[:, 2]).max() + 5)

        def update(i):
            line.set_data(xs[:i, 0], xs[:i, 1])
            line.set_3d_properties(-xs[:i, 2])
            dot.set_data(xs[i: i + 1, 0], xs[i: i + 1, 1])
            dot.set_3d_properties(-xs[i: i + 1, 2])
            return line, dot

        anim = FuncAnimation(fig, update, frames=xs.shape[0], blit=False)
        anim.save(path, writer=PillowWriter(fps=fps))
        plt.close(fig)


def aero_polars(params, alphas_deg, airspeed: float = 50.0) -> np.ndarray:
    """The six aero coefficients (len(alphas), 6) over a sweep of angle of
    attack at fixed airspeed, one batched call on the parameters' device:
    body velocity [V cos α, 0, V sin α] at identity attitude, so α is
    exact, and zero controls."""
    from aircraft_tpu_torch.dynamics.aircraft import coefficients

    dev = params.device
    a = torch.deg2rad(_on(alphas_deg, dev))
    n = a.shape[0]
    x = torch.zeros((n, 13), dtype=torch.float32, device=dev)
    x[:, 2] = -200.0
    x[:, 3] = airspeed * torch.cos(a)
    x[:, 5] = airspeed * torch.sin(a)
    x[:, 9] = 1.0
    with torch.no_grad():
        return _host(coefficients(params, x, torch.zeros(
            (n, 7), dtype=torch.float32, device=dev)))


def plot_polars(models: dict, path=None, airspeed: float = 50.0,
                alpha_range_deg=(-15.0, 20.0), n: int = 71):
    """α against CX and CZ across coefficient models (``models``:
    {label: AircraftParams}); saved to ``path`` when given; returns the
    figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    alphas = np.linspace(alpha_range_deg[0], alpha_range_deg[1], n)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for label, params in models.items():
        C = aero_polars(params, alphas, airspeed)
        axes[0].plot(alphas, C[:, 0], label=label)
        axes[1].plot(alphas, C[:, 2], label=label)
    axes[0].set_xlabel("α [deg]"); axes[0].set_ylabel("CX")
    axes[1].set_xlabel("α [deg]"); axes[1].set_ylabel("CZ")
    for ax in axes:
        ax.grid(True, alpha=0.3)
        ax.legend()
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, bbox_inches="tight")
    return fig
