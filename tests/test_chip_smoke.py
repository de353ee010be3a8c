"""chip_smoke.py refuses to report a result without a GPU, and without the
rest of the repository."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = str(shutil.copy(script, tmp_path))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
