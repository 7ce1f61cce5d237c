"""Configuration tree of the port (numpy only).

A copy of the parts of the reference configuration that the window-solve
path reads: the plant geometry, the declared state and control envelopes,
the waypoint set, the transcription option axes and the solver settings.
``glider_config()`` loads the canonical glider problem from
``data/glider/problem_definition.json``; ``GLIDER_PROBLEM`` is that file's
declared dict, which ``write_glider_problem_json`` writes out again.
Everything the port writes goes under ``BUILDPATH`` (or a path its caller
gives), never under ``data/``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

BASEPATH = Path(__file__).resolve().parent.parent
DATAPATH = BASEPATH / "data"
NETWORKPATH = DATAPATH / "networks"
GLIDER_PROBLEM_PATH = DATAPATH / "glider" / "problem_definition.json"
BUILDPATH = BASEPATH / "build" / "aircraft_tpu_torch"
VISUPATH = BUILDPATH / "visualisation"

RHO = 1.225  # air density used throughout the aero pipeline [kg/m^3]


@dataclass(frozen=True)
class AircraftConfig:
    """Geometry + inertia of the plant."""

    mass: float = 1.0
    span: float = 1.0
    length: float = 1.2
    chord: float = 1.0
    reference_area: float = 0.238
    aero_centre_offset: tuple[float, float, float] = (0.133, 0.0, 0.003)
    Ixx: float = 0.155
    Iyy: float = 0.114
    Izz: float = 0.262
    Ixz: float = 0.01
    r_min: float = 10.0
    glide_ratio: float = 10.0
    rudder_moment_arm: float = 0.5

    @classmethod
    def from_dict(cls, d: dict) -> "AircraftConfig":
        known = {f: d[f] for f in d if f in cls.__dataclass_fields__}
        if "aero_centre_offset" in known:
            known["aero_centre_offset"] = tuple(known["aero_centre_offset"])
        return cls(**known)

    @property
    def static_inertia(self) -> np.ndarray:
        """Body inertia tensor with the Ixz cross term."""
        return np.array([[self.Ixx, 0.0, self.Ixz],
                         [0.0, self.Iyy, 0.0],
                         [self.Ixz, 0.0, self.Izz]])


@dataclass(frozen=True)
class StateEnvelope:
    """Aero-angle / airspeed flight envelope in degrees and m/s."""

    alpha: tuple[float, float] = (-15.0, 15.0)
    beta: tuple[float, float] = (-15.0, 15.0)
    airspeed: tuple[float, float] = (30.0, 100.0)

    @classmethod
    def from_dict(cls, d: dict) -> "StateEnvelope":
        return cls(alpha=tuple(d.get("alpha", (-15.0, 15.0))),
                   beta=tuple(d.get("beta", (-15.0, 15.0))),
                   airspeed=tuple(d.get("airspeed", (30.0, 100.0))))


@dataclass(frozen=True)
class ControlEnvelope:
    """Control-surface bounds."""

    aileron: tuple[float, float] = (-5.0, 5.0)
    elevator: tuple[float, float] = (-5.0, 5.0)
    rudder: tuple[float, float] = (-5.0, 5.0)
    throttle: tuple = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    flaps: tuple[float, float] = (0.0, 1.0)
    centre_of_mass: tuple = ((-0.5, -0.1, -0.1), (0.5, 0.1, 0.1))

    @classmethod
    def from_dict(cls, d: dict) -> "ControlEnvelope":
        def pair(key, default):
            v = d.get(key, default)
            return tuple(tuple(x) if isinstance(x, (list, tuple)) else x
                         for x in v)

        return cls(
            aileron=pair("aileron_limit", (-5.0, 5.0)),
            elevator=pair("elevator_limit", (-5.0, 5.0)),
            rudder=pair("rudder_limit", (-5.0, 5.0)),
            throttle=pair("throttle_limit", ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))),
            flaps=pair("flaps_limit", (0.0, 1.0)),
            centre_of_mass=pair("centre_of_mass_limit",
                                ((-0.5, -0.1, -0.1), (0.5, 0.1, 0.1))),
        )

    def bounds(self, dim: int = 7) -> tuple[np.ndarray, np.ndarray]:
        """(lb, ub) for the control vector [da, de, dr, thrust(3), flaps]
        (+ CoM(3) for the 10-wide trim variant)."""
        lb = np.array([self.aileron[0], self.elevator[0], self.rudder[0],
                       *self.throttle[0], self.flaps[0]])
        ub = np.array([self.aileron[1], self.elevator[1], self.rudder[1],
                       *self.throttle[1], self.flaps[1]])
        if dim == 10:
            lb = np.concatenate([lb, np.array(self.centre_of_mass[0])])
            ub = np.concatenate([ub, np.array(self.centre_of_mass[1])])
        return lb[:dim], ub[:dim]


@dataclass(frozen=True)
class WaypointsConfig:
    """Waypoint set + initial condition.  ``waypoints`` excludes the
    initial position; 2D objectives back-fill altitude along the declared
    glide ratio."""

    waypoints: tuple = ()
    initial_state: tuple = (0.0,) * 13
    default_velocity: float = 50.0
    waypoint_indices: tuple = (0, 1, 2)
    tolerance: float = 1e-2

    @classmethod
    def from_dict(cls, d: dict, glide_ratio: float = 10.0) -> "WaypointsConfig":
        wps = np.array(d.get("waypoints", [[0.0, 0.0, 0.0]]), dtype=float)
        init = d.get("initial_state")
        if init is None:
            init = np.zeros(13)
            init[:3] = wps[0]
            init[9] = 1.0
        init = np.asarray(init, dtype=float)
        indices = tuple(d.get("waypoint_indices", [0, 1, 2]))
        if len(indices) < 3:
            pts = np.vstack([init[:3], wps])
            seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
            cum = np.concatenate([[0.0], np.cumsum(seg)])
            for i in range(len(wps)):
                wps[i, 2] = init[2] + cum[i + 1] / glide_ratio
        return cls(waypoints=tuple(tuple(w) for w in wps),
                   initial_state=tuple(init),
                   default_velocity=float(d.get("default_velocity", 50.0)),
                   waypoint_indices=indices,
                   tolerance=float(d.get("waypoint_tolerance", 1e-2)))

    @property
    def initial_position(self) -> np.ndarray:
        return np.array(self.initial_state[:3])

    def array(self) -> np.ndarray:
        return np.array(self.waypoints, dtype=float)

    def all_points(self) -> np.ndarray:
        """Initial position + waypoints, shape (n+1, 3)."""
        return np.vstack([self.initial_position, self.array()])

    def cumulative_distances(self) -> np.ndarray:
        """Path length from the initial position to each point of
        ``all_points``, shape (n+1,)."""
        seg = np.linalg.norm(np.diff(self.all_points(), axis=0), axis=1)
        return np.concatenate([[0.0], np.cumsum(seg)])


@dataclass(frozen=True)
class TrajectoryConfig:
    """Top-level problem definition (reference JSON schema)."""

    aircraft: AircraftConfig = field(default_factory=AircraftConfig)
    state: StateEnvelope = field(default_factory=StateEnvelope)
    control: ControlEnvelope = field(default_factory=ControlEnvelope)
    waypoints: WaypointsConfig = field(default_factory=WaypointsConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "TrajectoryConfig":
        aircraft = AircraftConfig.from_dict(d.get("aircraft", {}))
        return cls(aircraft=aircraft,
                   state=StateEnvelope.from_dict(d.get("state", {})),
                   control=ControlEnvelope.from_dict(d.get("control", {})),
                   waypoints=WaypointsConfig.from_dict(
                       d.get("waypoints", {}),
                       glide_ratio=aircraft.glide_ratio))

    @classmethod
    def from_json(cls, path) -> "TrajectoryConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        """The reference JSON schema (the keys ``from_dict`` reads), so
        ``TrajectoryConfig.from_dict(cfg.to_dict()) == cfg`` for 3D
        waypoint sets; a 2D set is not invertible, since ``from_dict``
        back-fills its altitudes along the glide ratio."""
        a, w, c = self.aircraft, self.waypoints, self.control
        return {
            "waypoints": {
                "waypoints": [list(p) for p in w.waypoints],
                "initial_state": list(w.initial_state),
                "default_velocity": w.default_velocity,
                "waypoint_indices": list(w.waypoint_indices),
                "waypoint_tolerance": w.tolerance,
            },
            "aircraft": {
                "mass": a.mass, "span": a.span, "length": a.length,
                "chord": a.chord, "reference_area": a.reference_area,
                "aero_centre_offset": list(a.aero_centre_offset),
                "Ixx": a.Ixx, "Iyy": a.Iyy, "Izz": a.Izz, "Ixz": a.Ixz,
                "r_min": a.r_min, "glide_ratio": a.glide_ratio,
                "rudder_moment_arm": a.rudder_moment_arm,
            },
            "state": {
                "alpha": list(self.state.alpha),
                "beta": list(self.state.beta),
                "airspeed": list(self.state.airspeed),
            },
            "control": {
                "aileron_limit": list(c.aileron),
                "elevator_limit": list(c.elevator),
                "rudder_limit": list(c.rudder),
                "throttle_limit": [list(t) for t in c.throttle],
                "flaps_limit": list(c.flaps),
                "centre_of_mass_limit": [list(m) for m in c.centre_of_mass],
            },
        }

    def save_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


TIME_MODES = ("fixed", "progress", "variable", "adaptive")
QUATERNION_MODES = ("", "constraint", "baumgarte", "integration")
INTEGRATION_MODES = ("explicit", "implicit")


@dataclass(frozen=True)
class TranscriptionConfig:
    """Option axes of the OCP transcription: horizon, timestep, time mode,
    quaternion handling and integration; a mode outside its tuple is
    refused."""

    num_nodes: int = 50
    dt: float = 0.01
    time: str = "fixed"              # fixed | progress | variable | adaptive
    quaternion: str = "integration"  # '' | constraint | baumgarte | integration
    integration: str = "explicit"    # explicit | implicit
    substeps: int = 1
    dt_bounds: tuple[float, float] = (1e-4, 1e-2)

    def __post_init__(self):
        assert self.time in TIME_MODES, self.time
        assert self.quaternion in QUATERNION_MODES, self.quaternion
        assert self.integration in INTEGRATION_MODES, self.integration


@dataclass(frozen=True)
class SolverConfig:
    """Batched AL-iLQR solver settings (field meanings as in the
    reference's ``SolverConfig``)."""

    max_al_iters: int = 12
    max_inner_iters: int = 30
    tol: float = 1e-6
    constraint_tol: float = 1e-6
    penalty_init: float = 10.0
    penalty_scale: float = 10.0
    penalty_max: float = 1e8
    penalty_per_row: bool = False
    penalty_row_scale: float = 10.0
    penalty_row_max: float = 1e3
    penalty_row_target: float = 1e-2
    reg_init: float = 1e-6
    reg_max: float = 1e8
    reg_escalate: float = 10.0
    reg_relax: float = 5.0
    line_search_steps: int = 12
    gain_clip: float = 1e4
    use_residual_gn: Optional[bool] = None
    riccati: str = "sequential"
    hessian: str = "exact"


# state / control scaling of the reference solve
DEFAULT_STATE_SCALE = np.array(
    [1e2, 1e2, 1e2, 50, 50, 50, 1, 1, 1, 1, np.pi, np.pi, np.pi])
DEFAULT_CONTROL_SCALE = np.array([10.0, 10.0, 1.0, 1.0, 1.0, 1.0, 1.0])


# The canonical glider problem as declared: the dict behind
# data/glider/problem_definition.json (2D waypoint objective; its
# altitudes are back-filled along the glide ratio on load)
GLIDER_PROBLEM: dict = {
    "waypoints": {
        "waypoints": [
            [150.0, 10.0, -190.0],
            [0.0, 20.0, -180.0],
            [150.0, 10.0, -190.0],
            [0.0, 0.0, -180.0],
        ],
        "initial_state": [0, 0, -200, 50, 0, 0, 0, 0, 0, 1, 0, 0, 0],
        "default_velocity": 30,
        "waypoint_indices": [0, 1],
        "waypoint_tolerance": 1e1,
    },
    "aircraft": {
        "mass": 4.0,
        "span": 2.0,
        "length": 1.2,
        "chord": 0.124605,
        "reference_area": 0.238,
        "aero_centre_offset": [0.133, 0, 0.003],
        "Ixx": 0.155,
        "Iyy": 0.114,
        "Izz": 0.262,
        "Ixz": 0.01,
        "glide_ratio": 3.0,
        "r_min": 1.0,
    },
    "state": {
        "alpha": [-15, 15],
        "beta": [-15, 15],
        "airspeed": [30, 100],
    },
    "control": {
        "aileron_limit": [-10, 10],
        "elevator_limit": [-10, 10],
        "rudder_limit": [-10, 10],
        "throttle_limit": [[0, 0, 0], [0, 0, 0]],
        "centre_of_mass_limit": [[-0.5, -0.1, -0.1], [0.5, 0.1, 0.1]],
    },
}


def glider_config() -> TrajectoryConfig:
    """The canonical glider problem (``data/glider/problem_definition.json``)."""
    return TrajectoryConfig.from_json(GLIDER_PROBLEM_PATH)


def write_glider_problem_json(
        path=BUILDPATH / "glider" / "problem_definition.json") -> Path:
    """Write the canonical problem as a standalone JSON: the raw declared
    ``GLIDER_PROBLEM``, not a loaded config's ``to_dict()`` (the glide-ratio
    altitude back-fill applies on load and must not be baked into the
    file).  The default path is under the build directory; returns it."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(GLIDER_PROBLEM, f, indent=2)
    return p
