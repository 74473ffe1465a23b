"""Ensemble-replication tests: E independent PT replicas in one batch."""

import numpy as np
import pytest

from bcm3_tpu.likelihoods import create_likelihood
from bcm3_tpu.model.prior import Prior
from bcm3_tpu.model.variables import VariableSet
from bcm3_tpu.sampler import PTConfig, SamplerPT

REF = "/root/reference/examples"


def _setup(example):
    varset = VariableSet.from_xml(f"{REF}/{example}/prior.xml")
    prior = Prior.from_xml(f"{REF}/{example}/prior.xml", varset)
    lik = create_likelihood(f"{REF}/{example}/likelihood.xml", varset)
    return prior, lik


def test_ensemble_shapes_and_pooling():
    prior, lik = _setup("banana")
    cfg = PTConfig(
        num_samples=40,
        use_every_nth=2,
        num_chains=4,
        num_ensembles=3,
        adapt_proposal_samples=20,
        adapt_proposal_times=1,
        seed=8,
    )
    s = SamplerPT(prior, lik, cfg)
    assert s.num_chains == 12
    assert len(s.temperatures) == 12
    res = s.run()
    # pooled output: (S*E, C, D)
    assert res["samples"].shape == (120, 4, 2)
    assert res["log_likelihood"].shape == (120, 4)
    assert len(res["temperatures"]) == 4
    assert np.isfinite(res["log_likelihood"][:, -1]).all()
    # all T=0 replicas accept every prior draw
    acc = res["acceptance"]
    t0_idx = [0, 4, 8]
    for i in t0_idx:
        assert acc["accepted_mutate"][i] == acc["attempted_mutate"][i]


def test_ensembles_are_independent():
    """Replica T=1 chains must not be identical (independent RNG streams)."""
    prior, lik = _setup("banana")
    cfg = PTConfig(
        num_samples=30,
        use_every_nth=1,
        num_chains=2,
        num_ensembles=4,
        adapt_proposal_samples=0,
        adapt_proposal_times=0,
        seed=21,
    )
    s = SamplerPT(prior, lik, cfg)
    res = s.run()
    x = res["samples"].reshape(30, 4, 2, 2)  # (S, E, C, D)
    e0 = x[:, 0, 1, :]
    e1 = x[:, 1, 1, :]
    assert not np.allclose(e0, e1)


@pytest.mark.slow
def test_ensemble_posterior_matches_single():
    """Pooled ensemble posterior must match the single-ensemble posterior."""
    prior, lik = _setup("banana")
    common = dict(
        num_samples=1200,
        use_every_nth=3,
        num_chains=4,
        adapt_proposal_samples=400,
        adapt_proposal_times=1,
        swapping_scheme="deterministic_even_odd",
    )
    res_e = SamplerPT(prior, lik, PTConfig(num_ensembles=6, seed=31, **common)).run()
    x = res_e["samples"]
    E = 6
    # second half of each replica's chain: samples are (s, e)-ordered
    S_total = x.shape[0]
    keep = np.arange(S_total) >= S_total // 2
    xs = x[keep, -1, :]
    m = xs.mean(axis=0)
    sd = xs.std(axis=0)
    # exact moments by quadrature
    g1 = np.linspace(-6, 4, 1200)
    g2 = np.linspace(-6, 20, 2400)
    X1, X2 = np.meshgrid(g1, g2, indexing="ij")
    logp = -0.5 * (X1 / 2.0) ** 2 - 0.5 * (X2 - (4 * X1 + (1 - X1) ** 2)) ** 2
    p = np.exp(logp - logp.max())
    p /= p.sum()
    m_exact = np.array([(p * X1).sum(), (p * X2).sum()])
    sd_exact = np.array(
        [
            np.sqrt((p * (X1 - m_exact[0]) ** 2).sum()),
            np.sqrt((p * (X2 - m_exact[1]) ** 2).sum()),
        ]
    )
    # pooled ensembles give much tighter MC error than a single chain
    assert np.all(np.abs(m - m_exact) < np.array([0.15, 0.45])), (m, m_exact)
    assert np.all(np.abs(sd - sd_exact) / sd_exact < 0.10), (sd, sd_exact)


def test_chunked_emission_bit_identical():
    """emit_chunk_size only changes the transfer schedule
    (pt.py chunked emission), never the sampled stream."""
    import numpy as np

    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import PTConfig, SamplerPT

    ref = "/root/reference/examples/banana"
    vs = VariableSet.from_xml(f"{ref}/prior.xml")
    prior = Prior.from_xml(f"{ref}/prior.xml", vs)
    lik = create_likelihood(f"{ref}/likelihood.xml", vs)
    common = dict(
        num_samples=40,
        use_every_nth=2,
        num_chains=4,
        num_ensembles=2,
        adapt_proposal_samples=20,
        adapt_proposal_times=1,
        seed=5,
    )
    r_mono = SamplerPT(prior, lik, PTConfig(emit_chunk_size=0, **common)).run()
    r_chunk = SamplerPT(prior, lik, PTConfig(emit_chunk_size=7, **common)).run()
    r_auto = SamplerPT(prior, lik, PTConfig(emit_chunk_size=None, **common)).run()
    np.testing.assert_array_equal(r_mono["samples"], r_chunk["samples"])
    np.testing.assert_array_equal(r_mono["samples"], r_auto["samples"])
    np.testing.assert_array_equal(
        r_mono["log_likelihood"], r_chunk["log_likelihood"]
    )


def test_emit_fixed_only_bit_identical_t1():
    """emit_fixed_only pulls only the fixed-temperature rows to the host
    (reference parity: SamplerPT.cpp:321-330 emits only
    GetIsFixedTemperature() chains); the T=1 stream must be bit-equal to
    the all-temperature emission's last column, and the store shape
    drops to one temperature."""
    import numpy as np

    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import PTConfig, SamplerPT

    ref = "/root/reference/examples/banana"
    vs = VariableSet.from_xml(f"{ref}/prior.xml")
    prior = Prior.from_xml(f"{ref}/prior.xml", vs)
    lik = create_likelihood(f"{ref}/likelihood.xml", vs)
    common = dict(
        num_samples=40,
        use_every_nth=2,
        num_chains=4,
        num_ensembles=2,
        adapt_proposal_samples=20,
        adapt_proposal_times=1,
        seed=5,
    )
    r_all = SamplerPT(prior, lik, PTConfig(**common)).run()
    r_fix = SamplerPT(prior, lik, PTConfig(emit_fixed_only=True, **common)).run()
    assert r_fix["samples"].shape[1] == 1
    assert r_fix["temperatures"].shape == (1,)
    assert r_fix["temperatures"][0] == 1.0
    np.testing.assert_array_equal(
        r_all["samples"][:, -1, :], r_fix["samples"][:, 0, :]
    )
    np.testing.assert_array_equal(
        r_all["log_likelihood"][:, -1], r_fix["log_likelihood"][:, 0]
    )
    np.testing.assert_array_equal(
        r_all["log_prior"][:, -1], r_fix["log_prior"][:, 0]
    )


def test_emit_dtype_rounds_identical_stream():
    """Reduced-precision emission (a device->host bandwidth lever) only
    rounds the emitted copy:
    the sampled stream is dtype-independent, so the float16 store must
    equal the float32 store cast to float16, element for element."""
    import jax.numpy as jnp
    import numpy as np

    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import PTConfig, SamplerPT

    ref = "/root/reference/examples/banana"
    vs = VariableSet.from_xml(f"{ref}/prior.xml")
    prior = Prior.from_xml(f"{ref}/prior.xml", vs)
    lik = create_likelihood(f"{ref}/likelihood.xml", vs)
    common = dict(
        num_samples=30,
        use_every_nth=2,
        num_chains=4,
        num_ensembles=2,
        seed=5,
    )
    # compare against the FULL-precision store cast directly to f16:
    # the device casts sampler-dtype -> f16 in one convert, so routing
    # the expectation through an intermediate f32 store would double-
    # round (f64 -> f32 -> f16) and differ at ~0.5 ulp of f16 for some
    # seeds
    r_full = SamplerPT(
        prior, lik, PTConfig(emit_dtype=None, **common)
    ).run()
    r16 = SamplerPT(
        prior, lik, PTConfig(emit_dtype=jnp.float16, **common)
    ).run()
    assert r16["samples"].dtype == np.float16
    np.testing.assert_array_equal(
        np.asarray(r_full["samples"]).astype(np.float16),
        r16["samples"],
    )
    np.testing.assert_array_equal(
        np.asarray(r_full["log_likelihood"]).astype(np.float16),
        r16["log_likelihood"],
    )


def test_device_gathered_history_equals_full_pull():
    """The device-side downsampled history gather (the fix for the
    multi-GB history pull at adaptation boundaries) must yield exactly
    the rows the pull-everything + host-downsample path selects, with
    an identical host-RNG stream."""
    import copy

    import numpy as np

    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.prior import Prior
    from bcm3_tpu.model.variables import VariableSet
    from bcm3_tpu.sampler import PTConfig, SamplerPT

    ref = "/root/reference/examples/banana"
    vs = VariableSet.from_xml(f"{ref}/prior.xml")
    prior = Prior.from_xml(f"{ref}/prior.xml", vs)
    lik = create_likelihood(f"{ref}/likelihood.xml", vs)
    cfg = PTConfig(
        num_samples=40,
        use_every_nth=2,
        num_chains=4,
        num_ensembles=3,
        adapt_proposal_samples=0,
        adapt_proposal_times=0,
        adapt_proposal_max_history_samples=50,
        seed=5,
    )
    s = SamplerPT(prior, lik, cfg)
    state = s._init_state()
    fn = s._make_segment_fn(40, False)
    state, _, _ = fn(state, tuple(s.proposals))

    rng_state = copy.deepcopy(s._host_rng.bit_generator.state)
    hist, count = s._history_matrices(state)
    C, E = s.ladder_size, s.num_ensembles
    full = [
        s._downsample_history(
            hist[i::C].reshape(E * count, s.num_variables)
        )
        for i in range(C)
    ]
    s._host_rng.bit_generator.state = rng_state
    gathered = s._ladder_downsampled_history(state, count)
    for i in range(C):
        np.testing.assert_array_equal(
            np.asarray(full[i]), np.asarray(gathered[i])
        )
