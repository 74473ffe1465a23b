"""End-to-end cellpop experiment tests
(reference: src/cellpop/CellPopulationLikelihood.cpp, Experiment.cpp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bcm3_tpu.likelihoods import create_likelihood
from bcm3_tpu.model.variables import VariableSet

SBML_NS = "http://www.sbml.org/sbml/level2/version4"
MATHML = "http://www.w3.org/1998/Math/MathML"

# A minimal dividing-cell model: 'mass' produced at rate k_growth,
# 'cytokinesis' produced at rate k_div -> cell divides at t = 1/k_div.
CELL_MODEL = f"""<?xml version="1.0"?>
<sbml xmlns="{SBML_NS}" level="2" version="4">
<model id="cell">
<listOfSpecies>
  <species id="mass" name="mass" initialAmount="1.0"/>
  <species id="cytokinesis" name="cytokinesis" initialAmount="0.0"/>
</listOfSpecies>
<listOfReactions>
  <reaction id="growth">
    <listOfProducts><speciesReference species="mass"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_growth</ci><ci>mass</ci></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="division_clock">
    <listOfProducts><speciesReference species="cytokinesis"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <ci>k_div</ci>
    </math></kineticLaw>
  </reaction>
</listOfReactions>
</model>
</sbml>
"""


@pytest.fixture
def setup(tmp_path):
    import h5py

    (tmp_path / "cell.xml").write_text(CELL_MODEL)

    # synthetic observed data: population-average mass at 5 timepoints,
    # generated from k_growth=0.1, k_div=0.25 (division at t=4)
    times = np.array([0.5, 2.0, 4.5, 6.0, 7.5])
    k_growth = 0.1
    obs = np.exp(k_growth * times)[None, :]  # avg mass (all cells same mass)
    with h5py.File(tmp_path / "data.nc", "w") as f:
        g = f.create_group("exp1")
        g.create_dataset("time", data=times)
        g.create_dataset("avg_mass", data=obs)

    lik_xml = tmp_path / "likelihood.xml"
    lik_xml.write_text(
        '<bcm_likelihood type="cell_population">\n'
        '<experiment name="exp1" model_file="cell.xml" data_file="data.nc"\n'
        '  num_cells="1" max_cells="7" divide_cells="true" entry_time="0"\n'
        '  solver_type="DP5" solver_relative_tolerance="1e-8"\n'
        '  solver_absolute_tolerance="1e-10" trailing_simulation_time="0.5">\n'
        '  <data type="time_course_population_average" data_name="avg_mass"\n'
        '    species_name="mass" error_model="normal" stdev="sd"/>\n'
        "</experiment>\n"
        "</bcm_likelihood>\n"
    )

    vs = VariableSet()
    vs.add_variable("k_growth")
    vs.add_variable("k_div")
    vs.add_variable("sd")
    lik = create_likelihood(str(lik_xml), vs)
    return lik, times, k_growth


def test_cellpop_logp_finite_and_peaked(setup):
    lik, times, k_growth = setup
    truth = jnp.asarray([0.1, 0.25, 0.05])
    lp_truth = float(lik.log_prob(truth))
    assert np.isfinite(lp_truth)
    lp_wrong = float(lik.log_prob(jnp.asarray([0.3, 0.25, 0.05])))
    assert lp_truth > lp_wrong


def test_cellpop_population_grows(setup):
    lik, times, k_growth = setup
    exp = lik.model.experiments[0]
    tv = jnp.asarray([0.1, 0.25, 0.05])
    res = exp.simulate(tv)
    # k_div = 0.25 -> divisions at t=4 and t=8 (after end 8.0) -> 3 cells
    active = np.asarray(res.active)
    assert active.sum() == 3
    np.testing.assert_allclose(float(res.division_time[0]), 4.0, atol=0.1)
    pop = np.asarray(exp._population_size(res, jnp.asarray([1.0, 5.0])))
    assert pop[0] == 1
    assert pop[1] == 2  # parent no longer alive, two daughters


def test_cellpop_jit_vmap(setup):
    lik, times, k_growth = setup
    f = jax.jit(jax.vmap(lik.log_prob))
    batch = jnp.asarray(
        [[0.1, 0.25, 0.05], [0.12, 0.25, 0.05], [0.1, 0.3, 0.08]]
    )
    out = np.asarray(f(batch))
    assert np.isfinite(out).all()
    # single eval must agree with batch member
    single = float(lik.log_prob(batch[0]))
    np.testing.assert_allclose(out[0], single, rtol=1e-10)


def test_two_phase_hostmatch_equals_log_prob(tmp_path):
    """The two-phase evaluation (device cost matrices + host LAP
    matching, for runtimes without in-graph callbacks) must equal the
    in-graph log_prob on a Hungarian-matched
    time-course config."""
    import h5py

    (tmp_path / "cell.xml").write_text(CELL_MODEL)
    times = np.linspace(0.5, 10.0, 8)
    rng = np.random.default_rng(5)
    # 3 observed cell traces with spread around the true growth
    tc = np.exp(0.1 * times)[None, :] * rng.lognormal(0, 0.1, size=(3, 1))
    avg = np.exp(0.1 * times)[None, :]
    with h5py.File(tmp_path / "data.nc", "w") as f:
        g = f.create_group("exp1")
        g.create_dataset("time", data=times)
        g.create_dataset("cell_mass", data=tc)
        g.create_dataset("avg_mass", data=avg)
    (tmp_path / "likelihood.xml").write_text(
        '<bcm_likelihood type="cell_population">\n'
        '<experiment name="exp1" model_file="cell.xml" data_file="data.nc"\n'
        '  num_cells="2" max_cells="8" divide_cells="true" entry_time="0"\n'
        '  solver_type="DP5" solver_relative_tolerance="1e-8"\n'
        '  solver_absolute_tolerance="1e-10" trailing_simulation_time="0.5">\n'
        '  <data type="time_course_population_average" data_name="avg_mass"\n'
        '    species_name="mass" error_model="normal" stdev="sd"/>\n'
        '  <data type="time_course" data_name="cell_mass"\n'
        '    species_name="mass" error_model="normal" stdev="sd"/>\n'
        "</experiment>\n"
        "</bcm_likelihood>\n"
    )
    vs = VariableSet()
    for name in ("k_growth", "k_div", "sd"):
        vs.add_variable(name)
    lik = create_likelihood(str(tmp_path / "likelihood.xml"), vs)

    batch = jnp.asarray(
        [[0.1, 0.25, 0.05], [0.12, 0.22, 0.08], [0.09, 0.3, 0.04]]
    )
    ref = np.asarray(jax.vmap(lik.log_prob)(batch))
    two = lik.model.log_prob_batch_hostmatch(batch)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(two, ref, rtol=1e-10)


def test_cascade_model_generator():
    """The species-scaling bench's auto-generated stiff cascades build
    through the real SBML->JAX path and evaluate finitely (the 21-species
    program also guards the unrolled-LU path, BCM3_SMALL_LU_MAX)."""
    import os
    import sys as _sys

    _sys.path.insert(
        0, os.path.join(os.path.dirname(__file__), "..", "tools")
    )
    from bench_cellpop_scaling import build_likelihood, cascade_model

    assert cascade_model(2).count("<species ") == 9  # 5 base + 2*2
    lik = build_likelihood(2, max_cells=16, num_cells=2, matched=False)
    x = jnp.asarray([0.1, 0.25, 0.15, 0.05])
    lp = float(lik.log_prob(x))
    assert np.isfinite(lp)
