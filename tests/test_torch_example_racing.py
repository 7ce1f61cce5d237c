"""The port's waypoint_racing example against the reference's, tiny, on
the CPU: at N=10, 1 x 2 (warm start 1 x 2, 2 substeps) finite, its course
equal to the reference example's ``CFG``, and the stability eigenvalues at
its trim within 1e-3 relative of the reference's
(``stability_eigenvalues``: the eigenvalues of ``continuous_jacobians``'
A in float64) at the same point.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from aircraft_tpu import config as jcfg
from aircraft_tpu.config import glider_config as jglider
from aircraft_tpu.dynamics.aircraft import AircraftParams as JParams
from aircraft_tpu.solvers.trim import continuous_jacobians as jjac

from aircraft_tpu_torch.examples import waypoint_racing

ROOT = Path(__file__).resolve().parent.parent


def test_waypoint_racing_tiny():
    ref_src = (ROOT / "examples" / "waypoint_racing.py").read_text()
    ns = {}
    # the reference example's CFG, built by its own statement
    tree = ast.parse(ref_src)
    cfg_stmt = next(n for n in tree.body if isinstance(n, ast.Assign)
                    and n.targets[0].id == "CFG")
    exec(compile(ast.Module([cfg_stmt], []), "cfg", "exec"),
         {"TrajectoryConfig": jcfg.TrajectoryConfig,
          "glider_config": jglider}, ns)
    assert json.dumps(waypoint_racing.CFG.to_dict()) == json.dumps(
        ns["CFG"].to_dict())

    rec, arr = waypoint_racing.run(num_nodes=10, substeps=2, al_iters=1,
                                   inner_iters=2, warm_iters=(1, 2),
                                   device="cpu")
    assert rec["finite"] and np.isfinite(arr["xs"]).all()
    assert arr["xs"].shape[0] == 11 and len(rec["closest_approaches"]) == 2
    trim = arr["trim"]
    jp = JParams.from_config(jglider().aircraft)
    A = jax.jit(lambda x, u: jjac(jp, x, u)[0])(
        jnp.asarray(trim.state.numpy()), jnp.asarray(trim.control.numpy()))
    ref = np.sort_complex(np.linalg.eigvals(np.asarray(A, np.float64)))
    port = np.sort_complex(arr["eigenvalues"])
    assert np.max(np.abs(port - ref)) <= 1e-3 * np.max(np.abs(ref))
