"""Shared set-up of the torch-port parity tests: one MHTT window problem
built in both packages from the same numbers.

The JAX package builds the reference problem; its plant parameters and
track points are read out as numpy arrays here and handed to the port, so
both packages compute the same function.  Inputs are drawn with numpy
from a seed.  Nothing here runs at import time.
"""

import numpy as np
import torch

import jax.numpy as jnp

from aircraft_tpu.config import glider_config as jax_glider_config
from aircraft_tpu.control.course import COURSE_OCP_KNOBS as JAX_KNOBS
from aircraft_tpu.control.course import course_track as jax_course_track
from aircraft_tpu.control.mhtt import build_mhtt_ocp as jax_build_mhtt_ocp
from aircraft_tpu.dynamics.aircraft import AircraftParams as JaxParams
from aircraft_tpu.dynamics.coefficients import (
    DefaultCoeffParams as JaxDefault,
    default_nn_coeff,
)

from aircraft_tpu_torch.config import glider_config
from aircraft_tpu_torch.control.course import COURSE_OCP_KNOBS
from aircraft_tpu_torch.control.mhtt import build_mhtt_ocp
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams
from aircraft_tpu_torch.dynamics.coefficients import (
    DefaultCoeffParams,
    mlp_from_numpy,
)

MLP_KEYS = ("w0", "b0", "w1", "b1", "w2", "b2", "input_mean", "input_std",
            "output_mean", "output_std")
PARAM_KEYS = ("mass", "S", "b", "c", "com", "static_inertia",
              "rudder_moment_arm", "gravity")
V_REF = 30.0


def jax_params(model="nn"):
    cfg = jax_glider_config()
    coeff = default_nn_coeff() if model == "nn" else JaxDefault()
    return JaxParams.from_config(cfg.aircraft, coeff=coeff)


def port_params(jp) -> AircraftParams:
    """The port's parameters from the reference's, through numpy."""
    arrays = {k: np.asarray(getattr(jp, k)) for k in PARAM_KEYS}
    arrays["epsilon"] = float(jp.epsilon)
    if hasattr(jp.coeff, "w0"):
        mlp = {k: np.asarray(getattr(jp.coeff, k)) for k in MLP_KEYS}
        mlp["Cn_rudder"] = float(jp.coeff.Cn_rudder)
        coeff = mlp_from_numpy(mlp, device="cpu")
    else:
        coeff = DefaultCoeffParams()
    return AircraftParams.from_numpy(arrays, coeff=coeff, device="cpu")


def knobs(jax_side: bool, *, squash=True, unit_scales=True):
    k = dict(JAX_KNOBS if jax_side else COURSE_OCP_KNOBS)
    k["envelope_overrides"] = {**k["envelope_overrides"],
                               "unit_scales": unit_scales}
    k["squash_box"] = squash
    return k


def build_pair(model="nn", *, squash=True, dt=0.01):
    """(jax dict, port dict) of the same window OCP: params, ocp, spec."""
    cfg = jax_glider_config()
    jp = jax_params(model)
    track = jax_course_track(cfg, v_ref=V_REF, glide_ld=8.5)
    pts = np.asarray(track.track_points).copy()
    pts[:, 2] -= pts[:, 2].max() + 20.0
    jspec = {}
    jocp = jax_build_mhtt_ocp(jp, cfg, jnp.asarray(pts), track.length(),
                              dt=dt, v_ref=V_REF, spec_out=jspec,
                              **knobs(True, squash=squash))
    pp = port_params(jp)
    tspec = {}
    tocp = build_mhtt_ocp(pp, glider_config(), torch.as_tensor(pts),
                          track.length(), dt=dt, v_ref=V_REF,
                          spec_out=tspec, **knobs(False, squash=squash))
    return (dict(params=jp, ocp=jocp, spec=jspec, track=track, pts=pts),
            dict(params=pp, ocp=tocp, spec=tspec))


def fleet_inputs(B, N, seed=0, reversed_lanes=2):
    """Initial augmented states along the course start (numpy) and small
    random controls.  The last `reversed_lanes` scenarios fly backwards
    through the air (body-frame u_rel < 0)."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(jax_glider_config().waypoints.initial_state, np.float32)
    z = np.concatenate([
        np.tile(x0[None], (B, 1)) + 0.01 * rng.standard_normal((B, 13)),
        np.linspace(0.1, 0.3, B)[:, None]], axis=1).astype(np.float32)
    z[:, 3:6] *= 30.0 / np.linalg.norm(z[:, 3:6], axis=1, keepdims=True)
    if reversed_lanes:
        z[-reversed_lanes:, 3] *= -1.0
    ws = (0.05 * rng.standard_normal((B, N, 7))).astype(np.float32)
    return z, ws


# the reference controller tests' small two-waypoint course
# (tests/test_control.py::short_course_config), as a dict both packages read
SHORT_COURSE = {
    "waypoints": {
        "waypoints": [[120.0, 10.0, -195.0], [240.0, -10.0, -190.0]],
        "initial_state": [0, 0, -200, 50, 0, 0, 0, 0, 0, 1, 0, 0, 0],
        "default_velocity": 45,
        "waypoint_indices": [0, 1, 2],
        "waypoint_tolerance": 10.0,
    },
    "aircraft": dict(
        mass=4.0, span=2.0, length=1.2, chord=0.124605,
        reference_area=0.238, aero_centre_offset=[0.133, 0, 0.003],
        Ixx=0.155, Iyy=0.114, Izz=0.262, Ixz=0.01,
        glide_ratio=3.0, r_min=1.0,
    ),
    "state": {"alpha": [-15, 15], "beta": [-15, 15], "airspeed": [30, 100]},
    "control": {
        "aileron_limit": [-10, 10],
        "elevator_limit": [-10, 10],
        "rudder_limit": [-10, 10],
        "throttle_limit": [[0, 0, 0], [0, 0, 0]],
        "centre_of_mass_limit": [[-0.5, -0.1, -0.1], [0.5, 0.1, 0.1]],
    },
}


def short_course_pair():
    """(jax dict, port dict) of the short course: config, params, track.
    The port's params and track points are the reference's, through
    numpy."""
    from aircraft_tpu.config import TrajectoryConfig as JaxTrajectoryConfig
    from aircraft_tpu.control.initialisation import DubinsInitialiser as JaxTrack

    from aircraft_tpu_torch.config import TrajectoryConfig
    from aircraft_tpu_torch.control.initialisation import DubinsInitialiser

    jcfg = JaxTrajectoryConfig.from_dict(SHORT_COURSE)
    jp = JaxParams.from_config(jcfg.aircraft)
    jtrack = JaxTrack(jcfg)
    cfg = TrajectoryConfig.from_dict(SHORT_COURSE)
    track = DubinsInitialiser(cfg)
    track.track_points = torch.as_tensor(np.array(jtrack.track_points))
    track.total_length = float(jtrack.total_length)
    return (dict(config=jcfg, params=jp, track=jtrack),
            dict(config=cfg, params=port_params(jp), track=track))
