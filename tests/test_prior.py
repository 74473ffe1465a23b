"""Prior XML parsing, vectorized log-pdf, and sampling tests."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st

from bcm3_tpu.model.prior import Prior
from bcm3_tpu.model.variables import VariableSet

REF_EXAMPLES = "/root/reference/examples"

MIXED_XML = """<?xml version="1.0" encoding="utf-8"?>
<prior>
  <variable name="u"  distribution="uniform" lower="-2.0" upper="3.0"/>
  <variable name="n"  distribution="normal" mu="0.5" sigma="1.5"/>
  <variable name="e"  distribution="exponential" lambda="2.0"/>
  <variable name="g"  distribution="gamma" k="2.0" theta="0.5"/>
  <variable name="b"  distribution="beta" a="2.0" b="3.0"/>
  <variable name="h"  distribution="half_cauchy" scale="1.0"/>
  <variable name="bp" distribution="beta_prime" a="2.0" b="3.0" scale="1.5"/>
  <variable name="em" distribution="exponential_mix" lambda="1.0" lambda2="0.2" mix="0.3"/>
  <variable name="r"  distribution="normal" mu="0.0" sigma="1.0" repeat="3"/>
</prior>
"""


@pytest.fixture
def mixed_prior(tmp_path):
    p = tmp_path / "prior.xml"
    p.write_text(MIXED_XML)
    return Prior.from_xml(str(p))


def test_parse_repeat(mixed_prior):
    assert mixed_prior.num_variables == 11
    assert mixed_prior.varset.names[8:] == ["r_0", "r_1", "r_2"]


def test_bounds(mixed_prior):
    lo, hi = mixed_prior.lower, mixed_prior.upper
    assert lo[0] == -2.0 and hi[0] == 3.0
    assert lo[1] == -np.inf and hi[1] == np.inf
    assert lo[2] == 0.0 and hi[2] == np.inf  # exponential
    assert lo[4] == 0.0 and hi[4] == 1.0  # beta


def test_log_pdf_matches_scipy(mixed_prior):
    x = np.array([0.5, 1.0, 0.3, 0.7, 0.4, 0.8, 1.1, 0.9, 0.1, -0.5, 2.0])
    expected = (
        st.uniform.logpdf(x[0], -2, 5)
        + st.norm.logpdf(x[1], 0.5, 1.5)
        + st.expon.logpdf(x[2], scale=0.5)
        + st.gamma.logpdf(x[3], 2.0, scale=0.5)
        + st.beta.logpdf(x[4], 2.0, 3.0)
        + st.halfcauchy.logpdf(x[5], scale=1.0)
        + st.betaprime.logpdf(x[6], 2.0, 3.0, scale=1.5)
        + np.log(
            0.3 * st.expon.pdf(x[7], scale=1.0) + 0.7 * st.expon.pdf(x[7], scale=5.0)
        )
        + st.norm.logpdf(x[8:]).sum()
    )
    got = float(mixed_prior.log_pdf(jnp.asarray(x)))
    np.testing.assert_allclose(got, expected, rtol=1e-9)


def test_log_pdf_outside_support(mixed_prior):
    x = np.full(11, 0.5)
    x[2] = -1.0  # exponential support violated
    assert float(mixed_prior.log_pdf(jnp.asarray(x))) == -np.inf


def test_sample_moments(mixed_prior):
    key = jax.random.PRNGKey(0)
    draws = np.asarray(mixed_prior.sample(key, (200_000,)))
    assert draws.shape == (200_000, 11)
    means = draws.mean(axis=0)
    np.testing.assert_allclose(means[0], 0.5, atol=0.02)  # uniform(-2,3)
    np.testing.assert_allclose(means[1], 0.5, atol=0.02)  # normal
    np.testing.assert_allclose(means[2], 0.5, atol=0.01)  # expon rate 2
    np.testing.assert_allclose(means[3], 1.0, atol=0.01)  # gamma 2*0.5
    np.testing.assert_allclose(means[4], 0.4, atol=0.01)  # beta 2/(2+3)
    # beta_prime mean = scale * a/(b-1) = 1.5
    np.testing.assert_allclose(means[6], 1.5, atol=0.05)
    # bounds respected
    assert draws[:, 0].min() >= -2.0 and draws[:, 0].max() <= 3.0
    assert draws[:, 2].min() >= 0.0


def test_marginal_mean_variance(mixed_prior):
    m = mixed_prior.marginal_mean()
    v = mixed_prior.marginal_variance()
    np.testing.assert_allclose(m[0], 0.5)
    np.testing.assert_allclose(v[0], 25.0 / 12.0)
    np.testing.assert_allclose(m[3], 1.0)
    np.testing.assert_allclose(v[3], 0.5)
    np.testing.assert_allclose(m[5], 1.0)  # half-cauchy: scale (reference quirk)
    np.testing.assert_allclose(v[5], 1.0)


def test_reference_examples_parse():
    for ex in ("banana", "multimodal_circular_ridge", "multimodal_gaussians", "truncated_t"):
        prior = Prior.from_xml(os.path.join(REF_EXAMPLES, ex, "prior.xml"))
        assert prior.num_variables >= 2


def test_dirichlet_block(tmp_path):
    xml = """<?xml version="1.0"?>
<prior>
  <variable name="d1" multivariate="true" id="1" distribution="dirichlet" alpha="2.0"/>
  <variable name="d2" multivariate="true" id="1" distribution="dirichlet" alpha="3.0"/>
  <variable name="d3" multivariate="true" id="1" distribution="dirichlet" alpha="4.0"/>
</prior>
"""
    p = tmp_path / "prior.xml"
    p.write_text(xml)
    prior = Prior.from_xml(str(p))
    assert len(prior.dirichlet_blocks) == 1
    x = jnp.asarray([0.2, 0.3, 0.5])
    expected = st.dirichlet.logpdf(np.array([0.2, 0.3, 0.5]), [2.0, 3.0, 4.0])
    np.testing.assert_allclose(float(prior.log_pdf(x)), expected, rtol=1e-9)
    draws = np.asarray(prior.sample(jax.random.PRNGKey(1), (50_000,)))
    np.testing.assert_allclose(draws.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(draws.mean(axis=0), [2 / 9, 3 / 9, 4 / 9], atol=0.01)


def test_prior_gradients_finite_float32():
    """Reverse-mode gradients of log_pdf must be finite in FLOAT32 at any
    prior draw: masked non-member family branches must use neutral
    substituted parameters, because an epsilon floor lets (x-0)/tiny
    overflow to inf and 0*inf = NaN leaks through the select even with a
    finite primal (this broke NUTS in f32; x64 hid it)."""
    import tempfile

    import jax

    from bcm3_tpu.likelihoods.poppk_synth import write_poppk_prior_xml

    d = tempfile.mkdtemp()
    write_poppk_prior_xml(os.path.join(d, "prior.xml"), 8, "one")
    vs = VariableSet.from_xml(os.path.join(d, "prior.xml"))
    prior = Prior.from_xml(os.path.join(d, "prior.xml"), vs)
    for seed in range(4):
        # cast draws to f32: weak-typed literals keep the whole log_pdf
        # computation in f32 even under an x64-enabled test session
        x0 = prior.sample(jax.random.PRNGKey(seed), (32,)).astype(jnp.float32)
        lp = jax.vmap(prior.log_pdf)(x0)
        g = jax.vmap(jax.grad(prior.log_pdf))(x0)
        assert lp.dtype == jnp.float32
        assert np.isfinite(np.asarray(lp)).all()
        assert np.isfinite(np.asarray(g)).all(), (
            f"NaN/inf prior gradient in float32 (seed {seed})"
        )
