"""End-to-end tests for the Hungarian-matched cellpop data-likelihood
types `duration` and `time_points` (reference:
src/cellpop/DataLikelihoodDuration.cpp:64-133,
DataLikelihoodTimePoints.cpp), including the two-phase
device-cost/host-match route equivalence-tested against the in-graph
callback path."""

import os
import tempfile

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bcm3_tpu.likelihoods import create_likelihood
from bcm3_tpu.model.variables import VariableSet

SBML_NS = "http://www.sbml.org/sbml/level2/version4"
MATHML = "http://www.w3.org/1998/Math/MathML"


def _reaction(rid, products, reactants, math):
    prods = "".join(f'<speciesReference species="{s}"/>' for s in products)
    reacts = "".join(f'<speciesReference species="{s}"/>' for s in reactants)
    plist = f"<listOfProducts>{prods}</listOfProducts>" if prods else ""
    rlist = f"<listOfReactants>{reacts}</listOfReactants>" if reacts else ""
    return (
        f'<reaction id="{rid}">{rlist}{plist}'
        f'<kineticLaw><math xmlns="{MATHML}">{math}</math></kineticLaw>'
        "</reaction>"
    )


def _cycle_model() -> str:
    """Minimal cell-cycle-like model with DNA-replication events so the
    G1phase / Sphase durations are defined: replicating_DNA ramps at
    k_rep (crossing 1e-4 = replication start), replicated_DNA ramps at
    k_rep2 * replicating_DNA (crossing 1.95 = replication finish)."""
    species = [
        '<species id="mass" initialAmount="1.0"/>',
        '<species id="cytokinesis" initialAmount="0.0"/>',
        '<species id="replicating_DNA" initialAmount="0.0"/>',
        '<species id="replicated_DNA" initialAmount="0.0"/>',
    ]
    reactions = [
        _reaction(
            "growth", ["mass"], [],
            "<apply><times/><ci>k_growth</ci><ci>mass</ci></apply>",
        ),
        _reaction("division_clock", ["cytokinesis"], [], "<ci>k_div</ci>"),
        _reaction(
            "replication", ["replicating_DNA"], [],
            "<apply><times/><ci>k_rep</ci><ci>mass</ci></apply>",
        ),
        _reaction(
            "replication_done", ["replicated_DNA"], [],
            "<apply><times/><ci>k_rep2</ci><ci>replicating_DNA</ci></apply>",
        ),
    ]
    return (
        f'<?xml version="1.0"?>\n<sbml xmlns="{SBML_NS}" level="2"'
        ' version="4">\n<model id="cell">\n'
        f"<listOfSpecies>{''.join(species)}</listOfSpecies>\n"
        "<listOfParameters/>\n"
        f"<listOfReactions>{''.join(reactions)}</listOfReactions>\n"
        "</model>\n</sbml>\n"
    )


def _build(data_block, datasets, extra_vars=(), num_cells=4, max_cells=16):
    d = tempfile.mkdtemp(prefix="cellpop_matched_")
    with open(os.path.join(d, "cell.xml"), "w") as f:
        f.write(_cycle_model())
    with h5py.File(os.path.join(d, "data.nc"), "w") as f:
        g = f.create_group("exp1")
        for name, arr in datasets.items():
            g.create_dataset(name, data=arr)
    with open(os.path.join(d, "likelihood.xml"), "w") as f:
        f.write(
            '<bcm_likelihood type="cell_population">\n'
            '<experiment name="exp1" model_file="cell.xml" data_file="data.nc"\n'
            f'  num_cells="{num_cells}" max_cells="{max_cells}"'
            ' divide_cells="true" entry_time="0"\n'
            '  solver_type="CVODE" solver_relative_tolerance="1e-6"\n'
            '  solver_absolute_tolerance="1e-6"'
            ' trailing_simulation_time="0.5">\n'
            '  <cell_variability distribution="diagonal_gaussian">\n'
            '    <variable model_parameter="k_rep"'
            ' apply="multiplicative_log" scale="cv_krep"/>\n'
            "  </cell_variability>\n"
            + data_block
            + "</experiment>\n"
            "</bcm_likelihood>\n"
        )
    vs = VariableSet()
    for name in ("k_growth", "k_div", "k_rep", "k_rep2", "cv_krep", "sd"):
        vs.add_variable(name)
    for name in extra_vars:
        vs.add_variable(name)
    return create_likelihood(os.path.join(d, "likelihood.xml"), vs)


_BASE = np.array([0.05, 0.22, 0.8, 0.9, 0.25, 0.3])


def _xs(batch=3, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        _BASE[None, :] * np.exp(0.08 * rng.normal(size=(batch, len(_BASE))))
    )


def test_duration_likelihood_end_to_end():
    obs = np.array([2.1, 2.4, 2.0, 2.6])
    lik = _build(
        '  <data type="duration" data_name="obs_dur" period="Sphase"\n'
        '    error_model="normal" stdev="sd" simulation_time="8.0"/>\n',
        {"obs_dur": obs},
    )
    xs = _xs()
    in_graph = np.asarray(jax.jit(jax.vmap(lik.log_prob))(xs))
    assert np.isfinite(in_graph).all()
    # durations respond to the replication-rate parameter
    x_hi = jnp.asarray(_BASE[None, :] * np.array([[1, 1, 3.0, 1, 1, 1]]))
    x_lo = jnp.asarray(_BASE[None, :] * np.array([[1, 1, 0.3, 1, 1, 1]]))
    lp_hi = float(lik.log_prob(x_hi[0]))
    lp_lo = float(lik.log_prob(x_lo[0]))
    assert lp_hi != lp_lo

    # two-phase host-match route == in-graph route
    two_phase = lik.model.log_prob_batch_hostmatch(xs)
    np.testing.assert_allclose(two_phase, in_graph, rtol=1e-10)


def test_time_points_likelihood_end_to_end():
    times = np.array([1.0, 2.5, 4.0])
    n_obs = 3
    rng = np.random.default_rng(5)
    obs = np.exp(0.05 * times)[:, None] * rng.lognormal(
        0.0, 0.1, size=(len(times), n_obs)
    )
    lik = _build(
        '  <data type="time_points" data_name="obs_tp"\n'
        '    species_name="mass" error_model="normal" stdev="sd"\n'
        '    time_dimension="time"/>\n',
        {"obs_tp": obs, "time": times},
    )
    xs = _xs(batch=3, seed=1)
    in_graph = np.asarray(jax.jit(jax.vmap(lik.log_prob))(xs))
    assert np.isfinite(in_graph).all()

    two_phase = lik.model.log_prob_batch_hostmatch(xs)
    np.testing.assert_allclose(two_phase, in_graph, rtol=1e-10)


def test_mixed_matched_types_two_phase():
    """duration + time_points + population-average in ONE experiment
    through the two-phase path (cost-triple ordering must line up with
    matched_dls)."""
    times = np.array([1.0, 3.0])
    obs_tp = np.exp(0.05 * times)[:, None] * np.ones((2, 2))
    obs_avg = np.exp(0.05 * times)[None, :]
    obs_dur = np.array([2.2, 2.5])
    lik = _build(
        '  <data type="time_points" data_name="obs_tp"\n'
        '    species_name="mass" error_model="normal" stdev="sd"\n'
        '    time_dimension="time"/>\n'
        '  <data type="duration" data_name="obs_dur" period="G1phase"\n'
        '    error_model="normal" stdev="sd" simulation_time="6.0"/>\n'
        '  <data type="time_course_population_average" data_name="obs_avg"\n'
        '    species_name="mass" error_model="normal" stdev="sd"\n'
        '    time_dimension="time"/>\n',
        {"obs_tp": obs_tp, "obs_dur": obs_dur, "obs_avg": obs_avg,
         "time": times},
    )
    exp = lik.model.experiments[0]
    assert len(exp.matched_dls) == 2
    xs = _xs(batch=2, seed=2)
    in_graph = np.asarray(jax.jit(jax.vmap(lik.log_prob))(xs))
    two_phase = lik.model.log_prob_batch_hostmatch(xs)
    assert np.isfinite(in_graph).all()
    np.testing.assert_allclose(two_phase, in_graph, rtol=1e-10)


def test_duration_two_phase_soft_fail():
    """A failed integration propagates -inf through the two-phase path
    exactly as in-graph (the reference's soft-fail convention)."""
    obs = np.array([2.0, 2.3])
    lik = _build(
        '  <data type="duration" data_name="obs_dur" period="Sphase"\n'
        '    error_model="normal" stdev="sd" simulation_time="8.0"/>\n',
        {"obs_dur": obs},
    )
    # absurd growth rate -> overflow -> ok=False -> -inf both ways
    bad = jnp.asarray([[5e4, 0.22, 0.8, 0.9, 0.25, 0.3]])
    in_graph = np.asarray(jax.vmap(lik.log_prob)(bad))
    two_phase = lik.model.log_prob_batch_hostmatch(bad)
    assert in_graph[0] == -np.inf
    assert two_phase[0] == -np.inf
