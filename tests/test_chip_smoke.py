"""chip_smoke.py runs only where JAX computes on an NVIDIA GPU: without
one it exits non-zero and prints no ok line."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_a_gpu(tmp_path, where):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert not os.path.exists(tmp_path / ".smoke_data")


def test_chip_smoke_rehearsal_passes():
    """Every phase of the one-card run, on the CPU backend at a small
    size: the jax engine's output must equal the NumPy oracle's record
    for record, and the wide engine must be bit-equal to FMIndexNumpy."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "chip_smoke.py", "--rehearse"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "rehearsal passed" in p.stdout
    assert '"ok"' not in p.stdout
    for cname in ("50mbp_se", "8mbp_pe_bam"):
        assert any(line.endswith("headers identical") and cname in line
                   and "identical in order to the --engine numpy oracle"
                   in line for line in p.stdout.splitlines()), cname
    assert "bit-equal to FMIndexNumpy" in p.stdout
