"""aircraft_tpu_torch — the PyTorch + CUDA port of aircraft_tpu.

The JAX package ``aircraft_tpu`` is the reference and is left untouched;
this package computes the same functions in PyTorch, with the fused
window-solve kernels written by hand in CUDA C++ for Hopper (``csrc/``).
It imports neither JAX nor anything of ``aircraft_tpu``.

Layouts follow the reference at every public function: state
``[p(3), v(3), q_xyzw(4), omega(3)]`` (13) plus track progress ``s`` (14),
controls (7), trajectories ``(B, N+1, 14)`` / ``(B, N, 7)``.
"""

from aircraft_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
