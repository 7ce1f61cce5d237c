"""The port on the card: its CUDA kernels against their plain versions
(``-m gpu``, skipped without a card), and ``chip_smoke.py``'s refusal to
report a result where there is no card or no package.

Nothing here imports JAX, so the machine with the card, which has no JAX,
runs this file on its own:

    python -m pytest tests/test_torch_cuda.py -q -m gpu
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["nn", "default"])
def test_cuda_kernels_match_plain_versions(model):
    """chip_smoke.py's small-batch check (reversed-flow lanes, N=10):
    gains and candidate costs within 1e-2, the chosen candidate replayed
    knot by knot within 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from aircraft_tpu_torch.kernels import window as win

    win.reset_launch_counts()
    op, inp = chip_smoke.reversed_batch(model)
    chip_smoke.hold_kernels(op, inp, f"{model} reversed")
    assert win.window_backward.launches == win.window_forward.launches == 1


def _smoke(cwd: Path, env_extra: dict):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    """Where torch sees no card the script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _smoke(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    """Alone in a directory the script exits non-zero and prints no result
    line, card or not."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path, {})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
