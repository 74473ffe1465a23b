"""PopPK likelihood tests: closed-form propagator vs scipy oracles,
full-likelihood value vs an independent numpy recomputation, DP5 solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
from scipy.linalg import expm

from bcm3_tpu.likelihoods.poppk import PopPKLikelihood, log_pdf_tnu4
from bcm3_tpu.likelihoods.poppk_synth import (
    make_poppk_varset,
    synthesize_trial,
    truth_to_values,
)
from bcm3_tpu.ode import linear_pk
from bcm3_tpu.ode.dp5 import solve_at_times


def test_log_pdf_tnu4_matches_scipy():
    xs = np.array([-2.0, 0.0, 1.5, 10.0])
    np.testing.assert_allclose(
        np.asarray(log_pdf_tnu4(jnp.asarray(xs), 1.0, 2.0)),
        st.t.logpdf(xs, 4, loc=1.0, scale=2.0),
        rtol=1e-10,
    )


def test_one_compartment_vs_expm():
    ka, ke, kel = 0.7, 0.03, 0.12
    A = np.array([[-(ka + ke), 0.0], [ka, -kel]])
    y0 = np.array([150.0, 30.0])
    for dt in (0.1, 1.0, 24.0):
        expected = expm(A * dt) @ y0
        got = np.asarray(
            linear_pk.propagate_one_compartment(jnp.asarray(y0), dt, ka, ke, kel)
        )
        np.testing.assert_allclose(got, expected, rtol=1e-9)


def test_one_compartment_degenerate_rates():
    # a == kel limit must be stable
    ka, ke, kel = 0.1, 0.02, 0.12  # a = 0.12 == kel
    A = np.array([[-(ka + ke), 0.0], [ka, -kel]])
    y0 = np.array([100.0, 0.0])
    expected = expm(A * 12.0) @ y0
    got = np.asarray(
        linear_pk.propagate_one_compartment(jnp.asarray(y0), 12.0, ka, ke, kel)
    )
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_two_compartment_vs_expm():
    ka, ke, kel, kpf, kpb = 0.5, 0.02, 0.1, 0.08, 0.05
    A = np.array(
        [
            [-(ka + ke), 0.0, 0.0],
            [ka, -(kel + kpf), kpb],
            [0.0, kpf, -kpb],
        ]
    )
    y0 = np.array([200.0, 10.0, 5.0])
    for dt in (0.5, 6.0, 24.0):
        expected = expm(A * dt) @ y0
        got = np.asarray(
            linear_pk.propagate_two_compartment(
                jnp.asarray(y0), dt, ka, ke, kel, kpf, kpb
            )
        )
        np.testing.assert_allclose(got, expected, rtol=1e-8)


def test_biphasic_switch():
    ka1, ka2, ke, kel = 0.8, 0.2, 0.02, 0.1
    y0 = np.array([100.0, 0.0])
    dt, sw = 12.0, 3.0
    A1 = np.array([[-(ka1 + ke), 0.0], [ka1, -kel]])
    A2 = np.array([[-(ka2 + ke), 0.0], [ka2, -kel]])
    expected = expm(A2 * (dt - sw)) @ (expm(A1 * sw) @ y0)
    got = np.asarray(
        linear_pk.propagate_biphasic(jnp.asarray(y0), dt, sw, ka1, ka2, ke, kel)
    )
    np.testing.assert_allclose(got, expected, rtol=1e-8)


def test_dp5_exponential_decay():
    f = lambda t, y, args: -args * y
    ts = jnp.linspace(0.0, 5.0, 11)
    res = solve_at_times(f, jnp.asarray([1.0]), ts, args=0.7)
    assert bool(res.ok)
    np.testing.assert_allclose(
        np.asarray(res.ys[:, 0]), np.exp(-0.7 * np.asarray(ts)), rtol=1e-5
    )


def test_dp5_events():
    # decay with a +1 jump at t=1 and t=2
    f = lambda t, y, args: -y

    def event(i, t, y, args):
        return jnp.where((i == 2) | (i == 4), y + 1.0, y)

    ts = jnp.asarray([0.0, 0.5, 1.0, 1.5, 2.0, 3.0])
    res = solve_at_times(f, jnp.asarray([1.0]), ts, event_fn=event)
    y = np.asarray(res.ys[:, 0])
    np.testing.assert_allclose(y[2], np.exp(-1.0), rtol=1e-5)  # pre-jump
    expected_3 = ((np.exp(-1.0) + 1) * np.exp(-0.5))
    np.testing.assert_allclose(y[3], expected_3, rtol=1e-5)


@pytest.fixture(scope="module")
def synth():
    trial, truth = synthesize_trial(num_patients=8, num_timepoints=16, seed=3)
    varset = make_poppk_varset(8, "one")
    lik = PopPKLikelihood(varset, trial, "one", "lapatinib")
    values = truth_to_values(truth, varset, "one")
    return trial, truth, varset, lik, values


def test_poppk_loglik_matches_numpy_oracle(synth):
    """Recompute the full likelihood independently in numpy/scipy."""
    trial, truth, varset, lik, values = synth
    got = float(lik.log_prob(jnp.asarray(values)))

    # oracle: scipy expm trajectory + t4 residuals
    from bcm3_tpu.likelihoods.poppk_synth import _propagate_np

    conversion = (1e6 / 581.06) / truth["vod"]
    expected = 0.0
    K = int(np.ceil(trial.time.max() / trial.dosing_interval[0]))
    for j in range(trial.num_patients):
        y = np.zeros(3)
        y[0] = trial.dose[j]
        states = [y.copy()]
        for k in range(1, K + 1):
            y = _propagate_np(
                y, trial.dosing_interval[j], truth["ka"][j], truth["ke"],
                truth["kel"][j], 0, 0, "one",
            )
            day = int((k * trial.dosing_interval[j]) // 24)
            if not (day < 29 and trial.interruptions[j, day]):
                y[0] += trial.dose[j]
            states.append(y.copy())
        for i, t in enumerate(trial.time):
            obs = trial.observed[j, i]
            if np.isnan(obs):
                continue
            k = max(0, int(np.floor((t - 1e-9) / trial.dosing_interval[j])))
            dt = t - k * trial.dosing_interval[j]
            yy = _propagate_np(
                states[k], dt, truth["ka"][j], truth["ke"], truth["kel"][j],
                0, 0, "one",
            )
            x = yy[1] * conversion
            sd = truth["sd"] + truth["sd2"] * max(x, 0.0)
            expected += st.t.logpdf(x, 4, loc=obs, scale=sd)
    np.testing.assert_allclose(got, expected, rtol=1e-7)


def test_poppk_vmap_jit(synth):
    trial, truth, varset, lik, values = synth
    batch = jnp.asarray(np.tile(values, (8, 1)))
    out = jax.jit(jax.vmap(lik.log_prob))(batch)
    assert out.shape == (8,)
    np.testing.assert_allclose(np.asarray(out), float(lik.log_prob(values)), rtol=1e-9)


def test_poppk_truth_beats_perturbed(synth):
    """The ground-truth parameters should outscore perturbed ones."""
    trial, truth, varset, lik, values = synth
    lp_truth = float(lik.log_prob(jnp.asarray(values)))
    perturbed = values.copy()
    perturbed[0] += 0.5  # shift population absorption by 0.5 log10
    lp_bad = float(lik.log_prob(jnp.asarray(perturbed)))
    assert lp_truth > lp_bad


def test_poppk_rejects_nan_as_neginf(synth):
    trial, truth, varset, lik, values = synth
    broken = values.copy()
    broken[3] = np.nan  # vod -> nan
    assert float(lik.log_prob(jnp.asarray(broken))) == -np.inf


def test_poppk_two_compartment_runs():
    trial, truth = synthesize_trial(
        num_patients=4, num_timepoints=12, seed=5, pk_type="two"
    )
    varset = make_poppk_varset(4, "two")
    lik = PopPKLikelihood(varset, trial, "two", "lapatinib")
    values = truth_to_values(truth, varset, "two")
    lp = float(lik.log_prob(jnp.asarray(values)))
    assert np.isfinite(lp)


def test_poppk_file_roundtrip(tmp_path, synth):
    trial, truth, varset, lik, values = synth
    fn = str(tmp_path / "pkdata.nc")
    trial.save(fn, "TRIAL1", "lapatinib")

    from bcm3_tpu.likelihoods.poppk import PopPKTrial

    loaded = PopPKTrial.load(fn, "TRIAL1", "lapatinib")
    np.testing.assert_allclose(loaded.time, trial.time)
    np.testing.assert_allclose(loaded.dose, trial.dose)
    lik2 = PopPKLikelihood(varset, loaded, "one", "lapatinib")
    np.testing.assert_allclose(
        float(lik2.log_prob(jnp.asarray(values))),
        float(lik.log_prob(jnp.asarray(values))),
        rtol=1e-12,
    )


def test_pkdata_roundtrip_without_h5py(tmp_path, monkeypatch):
    """Without h5py, save writes NetCDF-3 with <trial>_<name> variables and
    load reads it back through the scipy fallback."""
    import sys

    from bcm3_tpu.likelihoods.poppk import PopPKTrial

    trial, _ = synthesize_trial(num_patients=3, num_timepoints=6, seed=2)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py fails
    path = str(tmp_path / "pk.nc")
    trial.save(path, "T1", "lapatinib")
    with open(path, "rb") as f:
        assert f.read(3) == b"CDF"  # NetCDF-3 magic
    back = PopPKTrial.load(path, "T1", "lapatinib")
    for name in trial.__dataclass_fields__:
        a, b = np.asarray(getattr(trial, name)), np.asarray(getattr(back, name))
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_main_path_imports_without_h5py():
    """The sampling path (XML -> create_likelihood -> SamplerPT) and the
    posterior summaries import without h5py, which only output.nc needs."""
    import os
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "import bcm3_tpu.analysis, bcm3_tpu.likelihoods, bcm3_tpu.sampler\n"
        "import bcm3_tpu.model.prior, bcm3_tpu.model.variables\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
