#!/usr/bin/env python3
"""Times of the batched-Cholesky and fused-rollout kernels on the card,
without the rest of chip_smoke.py.

    python3 kernel_times.py

Needs one CUDA card and nvcc.  Runs chip_smoke.py's cholesky and rollout
phases (each kernel held against its plain version at the smoke's shapes,
then timed) and prints the card's name and power limit and one JSON line
of times in ms: `ms` the device time (torch.profiler), `graph_ms` the
Cholesky kernel in a CUDA graph, `wrapper_ms` CUDA events around wrapper
calls, `library_ms` the library factor-and-solve's device time, and
`bound_ms` the least time the card could take (aircraft_tpu_torch/
roofline.py, the counts chip_smoke.py uses).  Run in
two checkouts in one call, on one card, it compares two versions of the
kernels.  Without a card it exits non-zero and prints no times.

    python3 kernel_times.py --sweep

times only one Riccati backward pass at the fleet's shape (B=256, N=50)
on each Quu-solve route, host wall clock around a synchronised call, the
median of 5 (chip_smoke.sweep_host_s): the kernel route as the solver
runs it (its CUDA graph's replay, where the package has one, and then also
its eager sweep) and the reference route.  Copied beside another checkout's
package with chip_smoke.py and run there, it times that version's sweep.
"""

from __future__ import annotations

import json
import sys

import chip_smoke


def main(argv=None) -> int:
    import argparse

    import torch

    from aircraft_tpu_torch import roofline

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sweep", action="store_true",
                   help="only the host wall of one Riccati backward pass "
                   "at B=256, N=50 on each Quu-solve route")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    ocp, _, _, z0s, us, inp = chip_smoke.fleet_problem()
    if a.sweep:
        print(chip_smoke.smi_line())
        print(json.dumps({"backward_pass_host_s": chip_smoke.sweep_host_s(
            ocp, us, inp)}))
        return 0
    chol, chol_all, chol_cm = chip_smoke.cholesky_phase(ocp, z0s, us, inp)
    roll = chip_smoke.rollout_phase()
    keys = ("ms", "graph_ms", "wrapper_ms", "library_ms")
    times = {name: {**{k: c[k] for k in keys}, "bound_ms": c["bound"][0]}
             for name, c in (("batched_cholesky_B256_k15", chol),
                             ("batched_cholesky_B12800_k15", chol_all),
                             ("batched_cholesky_B12800_k8", chol_cm))}
    times["fused_rollout_B1024_N50_ss10"] = {
        **{k: roll[k] for k in ("ms", "wrapper_ms")},
        "bound_ms": roofline.bound_ms(roofline.rollout_work(
            1024, 50, 10, roll["op"].mlp.numel()))[0]}
    print(chip_smoke.smi_line())
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
