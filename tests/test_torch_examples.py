"""The port's twins of the JAX package's examples run on the CPU.

Each twin (``examples/<name>_torch.py``) runs as its own process with
``--device cpu`` (the kernels' plain versions) and must exit 0 and print
``True`` after each of its match lines' colons (oracle, batch identity,
isolation), and no ``False``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
# each twin and the match lines it prints
TWINS = {
    "quickstart": 3,
    "datamining_apps": 5,
    "stream_apps": 2,
    "serve_lm": 3,
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_example_twin_runs_on_the_cpu(name):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / f"{name}_torch.py"), "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    verdicts = re.findall(r":\s*(True|False)\b", out.stdout)
    assert verdicts == ["True"] * TWINS[name], out.stdout
