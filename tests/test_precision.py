"""Every contraction in a traced PT segment and in the device-side
adaptation programs runs at full float32 precision (a GPU may otherwise run
float32 dot products in TF32)."""

import os

import jax
import pytest

from bcm3_tpu.likelihoods import create_likelihood
from bcm3_tpu.model.prior import Prior
from bcm3_tpu.model.variables import VariableSet
from bcm3_tpu.sampler import PTConfig, SamplerPT


def _files(kind, d):
    if kind == "banana":
        from bcm3_tpu.example_files import write_banana_example

        return write_banana_example(d)
    from bcm3_tpu.likelihoods.poppk_synth import (
        synthesize_trial,
        write_poppk_likelihood_xml,
        write_poppk_prior_xml,
    )

    trial, _ = synthesize_trial(num_patients=4, num_timepoints=6, seed=1)
    pk = os.path.join(d, "pk.nc")
    trial.save(pk, "T1", "lapatinib")
    prior_xml, lik_xml = os.path.join(d, "prior.xml"), os.path.join(d, "lik.xml")
    write_poppk_prior_xml(prior_xml, 4, kind)
    write_poppk_likelihood_xml(lik_xml, pk, "T1", "lapatinib", kind)
    return prior_xml, lik_xml


@pytest.mark.parametrize("kind", ["banana", "one", "one_transit"])
def test_segment_dots_are_highest_precision(tmp_path, kind):
    prior_xml, lik_xml = _files(kind, str(tmp_path))
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    lik = create_likelihood(lik_xml, varset)
    s = SamplerPT(prior, lik, PTConfig(
        num_samples=2, num_chains=3, num_ensembles=2, seed=0,
        adapt_proposal_samples=0, adapt_proposal_times=0,
    ))
    state = s._init_state()
    _assert_highest(
        s._make_segment_fn(1).lower(state, tuple(s.proposals)).as_text()
    )


def _assert_highest(text):
    dots = [line for line in text.splitlines() if "dot_general" in line]
    assert dots, "the program contracts; one without dots is suspect"
    for line in dots:
        assert "precision = [HIGHEST, HIGHEST]" in line, line


def test_device_gmm_fit_dots_are_highest_precision():
    """The adaptation program: the batched EM of the device GMM fit."""
    import jax.numpy as jnp

    from bcm3_tpu.stats.gmm_device import _em_fits

    F, n, K, D = 2, 16, 3, 2
    f32 = jnp.float32
    text = _em_fits.lower(
        jax.ShapeDtypeStruct((F, n, D), f32),
        jax.ShapeDtypeStruct((F, n, K), f32),
        jax.ShapeDtypeStruct((F, K), jnp.bool_),
        jax.ShapeDtypeStruct((F,), f32),
    ).as_text()
    _assert_highest(text)


def test_cluster_assignment_dots_are_highest_precision():
    """The clustered proposal's per-chain cluster assignment."""
    import jax.numpy as jnp

    from bcm3_tpu.sampler.spectral import ClusterAssigner, assign_batch

    n, k, D, C = 12, 3, 2, 4
    z = lambda *shape: jnp.zeros(shape, jnp.float32)  # noqa: E731
    a = ClusterAssigner(z(D), z(n, D), z(n), z(n, n), z(n, k), z(k, k))
    text = jax.jit(assign_batch).lower(a, z(C, D)).as_text()
    _assert_highest(text)
