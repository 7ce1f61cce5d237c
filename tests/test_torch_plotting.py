"""The port's plotting against the reference's.

* ``aero_polars`` (71 α, default and trained-MLP aero) within 2e-4
  (1 + |ref|) of the reference's.
* ``TrajectoryPlotter._plant_panels`` (α, β, forces, moments; with and
  without wind) and the Euler angles within 2e-4 (1 + |ref|), on a
  20-step rollout of the reference's plant (the reference's own
  ``TestPlantTruePlotting`` case).
* The dashboard renders under Agg with the reference's axes and titles,
  with and without params, and ``plot_polars`` with its two axes.
"""

import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from aircraft_tpu.config import glider_config as jglider  # noqa: E402
from aircraft_tpu.dynamics.aircraft import AircraftParams as JParams  # noqa: E402
from aircraft_tpu.surrogates.models import load_mlp as jload_mlp  # noqa: E402
from aircraft_tpu.plotting import plotting as jplot  # noqa: E402
from aircraft_tpu.solvers import integrators as jint  # noqa: E402
from aircraft_tpu.solvers.rollout import rollout as jrollout  # noqa: E402
from aircraft_tpu.utils import TrajectoryData as JData  # noqa: E402

from aircraft_tpu_torch.config import NETWORKPATH, glider_config  # noqa: E402
from aircraft_tpu_torch.dynamics.aircraft import AircraftParams  # noqa: E402
from aircraft_tpu_torch.dynamics.coefficients import load_mlp  # noqa: E402
from aircraft_tpu_torch.plotting import plotting as tplot  # noqa: E402
from aircraft_tpu_torch.utils import TrajectoryData  # noqa: E402

TOL = 2e-4
WIND = [5.0, -2.0, 1.0]


def _err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape
    return float(np.max(np.abs(a - ref) / (1.0 + np.abs(ref))))


def _params(model):
    cfg = glider_config()
    if model == "default":
        return (JParams.from_config(jglider().aircraft),
                AircraftParams.from_config(cfg.aircraft, device="cpu"))
    return (JParams.from_config(jglider().aircraft,
                                coeff=jload_mlp(NETWORKPATH / "mlp.npz")),
            AircraftParams.from_config(cfg.aircraft,
                                       coeff=load_mlp(device="cpu"),
                                       device="cpu"))


@pytest.fixture(scope="module")
def flight():
    """The reference's plotting case, 20 steps of its plant (2
    substeps) from the problem's initial state, under an aileron ramp."""
    jp, _ = _params("default")
    x0 = jnp.asarray(jglider().waypoints.initial_state, jnp.float32)
    us = np.zeros((20, 7), np.float32)
    us[:, 0] = np.linspace(-2.0, 2.0, 20)        # some aileron
    step = jint.make_step_fn(jp, substeps=2, normalize="step")
    xs = np.asarray(jrollout(step, x0, jnp.asarray(us), 0.01))
    return xs, us


@pytest.mark.parametrize("model", ["default", "mlp"])
def test_aero_polars_match(model):
    jp, tp = _params(model)
    alphas = np.linspace(-15.0, 20.0, 71)
    port = tplot.aero_polars(tp, alphas)
    assert port.shape == (71, 6)
    assert _err(port, jplot.aero_polars(jp, alphas)) <= TOL


@pytest.mark.parametrize("wind", [None, WIND])
def test_plant_panels_match(flight, wind):
    xs, us = flight
    jp, tp = _params("default")
    ref = jplot.TrajectoryPlotter(
        params=jp, wind=None if wind is None else jnp.asarray(wind))\
        ._plant_panels(xs, us)
    port = tplot.TrajectoryPlotter(params=tp, wind=wind)._plant_panels(xs, us)
    for a, b in zip(port, ref):
        assert _err(a, b) <= TOL
    assert tplot.TrajectoryPlotter(params=tp)._plant_panels(xs, None) is None


def test_euler_matches(flight):
    xs, _ = flight
    assert _err(tplot._euler(xs, "cpu"), jplot._euler(xs)) <= TOL


@pytest.mark.parametrize("with_params", [False, True])
def test_dashboard_axes_match(flight, with_params):
    xs, us = flight
    lam = np.linspace(1, 0, 21)[:, None]
    jp, tp = _params("default")
    ref = jplot.TrajectoryPlotter(params=jp if with_params else None).plot(
        JData(state=xs, control=us, lam=lam))
    port = tplot.TrajectoryPlotter(
        params=tp if with_params else None, device="cpu").plot(
        TrajectoryData(state=xs, control=us, lam=lam))
    try:
        assert len(port.axes) == len(ref.axes)
        assert [a.get_title() for a in port.axes] == [
            a.get_title() for a in ref.axes]
    finally:
        plt.close(port)
        plt.close(ref)


def test_plot_polars_and_save(tmp_path, flight):
    _, tp = _params("default")
    fig = tplot.plot_polars({"default": tp}, path=tmp_path / "polars.png",
                            n=11)
    assert len(fig.axes) == 2 and (tmp_path / "polars.png").exists()
    plt.close(fig)
    xs, us = flight
    tplot.TrajectoryPlotter(device="cpu").save(
        TrajectoryData(state=xs, control=us), tmp_path / "dash.png")
    assert (tmp_path / "dash.png").stat().st_size > 0
