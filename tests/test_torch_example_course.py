"""The port's full_course example, tiny, on the CPU: at 2 windows (1 x 1
per window through the example's ``COURSE_INNER`` / ``COURSE_AL`` knobs)
its report holds every key of the reference example's report (read from
``examples/full_course.py``), under ``<out>/runs/``, with the trajectory
under ``<out>/visualisation/``.
"""

import ast
import json
from pathlib import Path

from aircraft_tpu_torch.examples import full_course

ROOT = Path(__file__).resolve().parent.parent


def test_full_course_report_keys(tmp_path, monkeypatch, capsys):
    ref_src = (ROOT / "examples" / "full_course.py").read_text()
    report = next(n.value for n in ast.walk(ast.parse(ref_src))
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "report")
    ref_keys = {k.value for k in report.keys}
    monkeypatch.setenv("COURSE_INNER", "1")
    monkeypatch.setenv("COURSE_AL", "1")
    rc = full_course.main(["--device", "cpu", "--max-windows", "2",
                           "--out", str(tmp_path)])
    assert rc in (0, 1)
    path = tmp_path / "runs" / "course_cpu_carry_i1.json"
    rec = json.loads(path.read_text())
    assert ref_keys <= set(rec), sorted(ref_keys - set(rec))
    assert rec["windows"] == 2 and rec["compile_cache_entries_at_start"] == 0
    assert rec["device"] == "cpu"
    assert (tmp_path / "visualisation" / "full_course.npz").exists()
