"""Mesh-sharded PT execution on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

from bcm3_tpu.likelihoods import create_likelihood
from bcm3_tpu.model.prior import Prior
from bcm3_tpu.model.variables import VariableSet
from bcm3_tpu.sampler import PTConfig, SamplerPT

REF = "/root/reference/examples"


def test_sharded_run_matches_unsharded():
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    varset = VariableSet.from_xml(f"{REF}/banana/prior.xml")
    prior = Prior.from_xml(f"{REF}/banana/prior.xml", varset)
    lik = create_likelihood(f"{REF}/banana/likelihood.xml", varset)
    common = dict(
        num_samples=40,
        use_every_nth=2,
        num_chains=4,
        num_ensembles=2,  # 8 chains over 8 devices
        adapt_proposal_samples=20,
        adapt_proposal_times=1,
        seed=9,
    )
    res_plain = SamplerPT(prior, lik, PTConfig(**common)).run()
    res_shard = SamplerPT(
        prior, lik, PTConfig(shard_over_devices=True, **common)
    ).run()
    # sharding must not change the computation
    np.testing.assert_allclose(
        res_shard["samples"], res_plain["samples"], rtol=1e-10
    )


def test_sharded_run_rejects_indivisible():
    varset = VariableSet.from_xml(f"{REF}/banana/prior.xml")
    prior = Prior.from_xml(f"{REF}/banana/prior.xml", varset)
    lik = create_likelihood(f"{REF}/banana/likelihood.xml", varset)
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    cfg = PTConfig(
        num_samples=4, num_chains=3, shard_over_devices=True,
        adapt_proposal_samples=0, adapt_proposal_times=0, seed=1,
    )
    with pytest.raises(ValueError, match="divisible"):
        SamplerPT(prior, lik, cfg).run()
