"""The port's twins of the JAX package's examples, on the CPU:
``examples/quickstart_torch.py`` prints what ``examples/quickstart.py``
prints (the simulator's decisions match bit for bit), and
``examples/migrate_zero_delay_torch.py --device cpu`` runs its three acts
(the stage-boundary migration held to the unmigrated run, the fault drill
and the live repartition with no HP miss)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, *args], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_quickstart_twin_prints_the_reference():
    pytest.importorskip("jax")
    assert (_run("examples/quickstart_torch.py")
            == _run("examples/quickstart.py"))


def test_migrate_zero_delay_twin_on_the_cpu():
    out = _run("examples/migrate_zero_delay_torch.py", "--device", "cpu")
    assert "partition A: cpu" in out
    assert "minus all-B| / max |all-B| = 0.00e+00" in out
    assert out.count("HP DMR 0.0%") == 2
