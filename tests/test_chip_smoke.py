"""chip_smoke.py: refuses to run without a GPU, and its comparison rule."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_fails_without_gpu(tmp_path, where):
    """On a CPU-only machine, and in a directory holding chip_smoke.py and
    nothing else of the repo, the script exits non-zero and prints no
    result."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize(
    "got,ref,flip,ok",
    [
        ([1.0, -2.0, -np.inf], [1.0, -2.0, -np.inf], 0.0, True),
        ([1.0, -2.1, -3.0], [1.0, -2.0, -3.0], 0.0, False),  # outside rtol
        ([1.0, -2.0, -np.inf], [1.0, -2.0, -3.0], 0.0, False),  # soft-fail
        ([1.0, -2.0, -np.inf], [1.0, -2.0, -3.0], 0.5, True),
    ],
)
def test_compare(got, ref, flip, ok):
    res = _chip_smoke().compare(np.array(got), np.array(ref), 1e-3, 0.0, flip)
    assert res["ok"] is ok


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.mark.parametrize(
    "got,ref,sd,seeds,z",
    [
        ([1.0, 2.0], [1.0, 2.0], [0.1, 0.1], 40, [0.0, 0.0]),
        # one run against the mean of many: sd * sqrt(1 + 1/seeds)
        ([1.3], [1.0], [0.1], 40, [0.3 / (0.1 * np.sqrt(1.025))]),
        ([0.9], [1.0], [0.1], 1, [-0.1 / (0.1 * np.sqrt(2.0))]),
        # a statistic with no spread between seeds must match exactly
        ([1.0, 0.5], [1.0, 0.4], [0.0, 0.0], 40, [0.0, np.inf]),
    ],
)
def test_run_level_z(got, ref, sd, seeds, z):
    out = _chip_smoke().run_level_z(got, ref, sd, seeds)
    np.testing.assert_allclose(np.abs(out), np.abs(z), rtol=1e-12)


def test_banana_moments_use_samples_after_the_boundary():
    """Emitted samples are (samples x ensembles, 1, 2), sample-major; the
    moments pool the ensembles after the adaptation boundary only."""
    num_samples, ensembles, adapt_at = 6, 3, 2
    x = np.zeros((num_samples, ensembles, 2))
    x[:adapt_at] = 100.0  # before the boundary: must not count
    x[adapt_at:, :, 0] = np.arange(4 * 3).reshape(4, 3)
    x[adapt_at:, :, 1] = -1.0
    res = {"samples": x.reshape(num_samples * ensembles, 1, 2)}
    mom = _chip_smoke().banana_moments(res, ensembles, num_samples, adapt_at)
    np.testing.assert_allclose(mom["mean"], [5.5, -1.0])
    np.testing.assert_allclose(mom["sd"], [np.std(np.arange(12.0)), 0.0])
