"""Transit budget-DP5 kernel tests (bcm3_tpu/ops/transit_pallas.py).

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``);
the same code compiles through Triton for the GPU, where the test marked
``gpu`` runs it."""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bcm3_tpu.ops import transit_pallas
from bcm3_tpu.ops.transit_pallas import BLOCK_LANES, transit_solve


def _transit_setup(tmp_path, P=4, T=10):
    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.likelihoods.poppk_synth import (
        synthesize_trial,
        write_poppk_likelihood_xml,
        write_poppk_prior_xml,
    )
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet

    trial, truth = synthesize_trial(num_patients=P, num_timepoints=T, seed=7)
    pk = os.path.join(tmp_path, "pkdata.nc")
    trial.save(pk, "TRIAL1", "lapatinib")
    write_poppk_prior_xml(os.path.join(tmp_path, "prior.xml"), P, "one_transit")
    write_poppk_likelihood_xml(
        os.path.join(tmp_path, "lik.xml"), pk, "TRIAL1", "lapatinib",
        "one_transit",
    )
    vs = VariableSet.from_xml(os.path.join(tmp_path, "prior.xml"))
    prior = Prior.from_xml(os.path.join(tmp_path, "prior.xml"), vs)
    lik = create_likelihood(os.path.join(tmp_path, "lik.xml"), vs)
    return prior, lik


@pytest.fixture
def f32():
    """The kernel computes in float32 only, and the XLA reference path
    promotes to float64 under x64: compare the two with x64 off."""
    with jax.enable_x64(False):
        yield


def _draws(prior, n, seed):
    return prior.sample(jax.random.PRNGKey(seed), (n,)).astype(jnp.float32)


def test_transit_pallas_matches_vmap_path(tmp_path, f32):
    """The fused transit kernel (ops/transit_pallas.py) must agree with
    the solve_at_times_budget likelihood path — same tableau, controller
    and soft-fail semantics (interpreter mode on CPU)."""
    prior, lik = _transit_setup(str(tmp_path))
    m = lik.model
    xs = _draws(prior, 6, 2)

    ref = np.asarray(jax.vmap(m.log_prob)(xs))
    got = np.asarray(m._log_prob_batched_transit_kernel(xs, interpret=True))

    fin_r, fin_g = np.isfinite(ref), np.isfinite(got)
    # soft-fail sets must agree (same budget, same controller)
    np.testing.assert_array_equal(fin_r, fin_g)
    if fin_r.any():
        np.testing.assert_allclose(
            got[fin_r], ref[fin_r], rtol=5e-3, atol=1e-2
        )


@pytest.mark.parametrize("draws", [1, BLOCK_LANES // 4, BLOCK_LANES // 4 + 3])
def test_transit_kernel_matches_budget_dp5(tmp_path, f32, draws):
    """Central-compartment trajectories of the kernel against the XLA
    budget-DP5 solve (_simulate_transit), lane by lane; the lane counts
    (4 patients per draw) are below, equal to and not a multiple of the
    kernel's block."""
    prior, lik = _transit_setup(str(tmp_path))
    m = lik.model
    xs = _draws(prior, draws, 3)
    p, _, _ = jax.vmap(m._patient_params)(xs)
    ref = np.asarray(jax.vmap(lambda v: m._simulate_transit(
        m._patient_params(v)[0]))(xs))  # (B, P, T)

    B, P = xs.shape[0], m.trial.num_patients
    flat = lambda x: jnp.broadcast_to(  # noqa: E731
        x[:, None] if x.ndim == 1 else x, (B, P)).reshape(-1)
    params = {k: flat(p[k]) for k in ("ka", "ke", "kel", "k_transit",
                                      "n_transit")}
    params["dose0"] = jnp.tile(jnp.asarray(m.initial_dose, jnp.float32), B)
    grid = jnp.tile(jnp.asarray(m.tr_grid.T, jnp.float32), (1, B))
    amt = jnp.tile(jnp.asarray(
        np.where(m.tr_is_dose, m.tr_dose_amt, 0.0).T, jnp.float32), (1, B))
    central, ok = transit_solve(
        params, grid, amt, trips=m.solver_trips, rtol=1e-6,
        atol=float(np.min(m.trial.dose)) * 1e-6, min_dt=1e-5, interpret=True,
    )
    S = grid.shape[0]
    assert central.shape == (S, B * P) and ok.shape == (B * P,)
    central = np.asarray(central).reshape(S, B, P).transpose(1, 2, 0)
    got = central[:, np.arange(P)[:, None], m.tr_obs_pos]  # (B, P, T)

    ok_ref = np.isfinite(ref).all(axis=-1)
    np.testing.assert_array_equal(np.asarray(ok).reshape(B, P), ok_ref)
    assert np.isnan(got[~ok_ref]).all()
    np.testing.assert_allclose(got[ok_ref], ref[ok_ref], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize(
    "backend,dtype,expected",
    [
        ("cpu", jnp.float32, False),
        ("cpu", jnp.float64, False),
        ("gpu", jnp.float32, True),
        ("gpu", jnp.float64, False),
    ],
)
def test_transit_dispatch(tmp_path, monkeypatch, backend, dtype, expected):
    """The kernel is taken for float32 on a GPU backend only."""
    _, lik = _transit_setup(str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert lik.model.uses_transit_kernel(dtype) is expected


def test_cpu_never_takes_kernel(tmp_path, monkeypatch, f32):
    """On the CPU the batched path is XLA's, bit for bit, and neither the
    kernel nor its interpreter is reached."""
    prior, lik = _transit_setup(str(tmp_path))

    def refuse(*a, **k):
        raise AssertionError("kernel reached on the CPU")

    monkeypatch.setattr(transit_pallas, "transit_solve", refuse)
    xs = _draws(prior, 3, 4)
    np.testing.assert_array_equal(
        np.asarray(lik.log_prob_batched(xs)),
        np.asarray(jax.vmap(lik.log_prob)(xs)),
    )
    assert inspect.signature(transit_solve).parameters["interpret"].default is False


def test_kernel_rejects_non_f32():
    L, S = 5, 3
    params = {k: jnp.ones(L, jnp.float64) for k in
              ("ka", "ke", "kel", "k_transit", "n_transit", "dose0")}
    grid = jnp.ones((S, L), jnp.float64)
    with pytest.raises(TypeError, match="float32"):
        transit_solve(params, grid, grid, interpret=True)


@pytest.mark.gpu
def test_transit_kernel_compiled_on_gpu(tmp_path, f32):
    """The Triton-compiled kernel against XLA's lowering on the card."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
    prior, lik = _transit_setup(str(tmp_path))
    xs = _draws(prior, 64, 5)
    assert lik.model.uses_transit_kernel(xs.dtype)
    got = np.asarray(jax.jit(lik.log_prob_batched)(xs))
    ref = np.asarray(jax.jit(jax.vmap(lik.log_prob))(xs))
    fin = np.isfinite(ref) & np.isfinite(got)
    assert np.mean(np.isfinite(ref) != np.isfinite(got)) <= 0.05
    np.testing.assert_allclose(got[fin], ref[fin], rtol=5e-2, atol=1e-2)
