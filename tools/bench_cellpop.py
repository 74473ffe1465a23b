"""Cellpop benchmark at reference scale, with optional profiler capture.

VERDICT r1 item 6: run a full cell-population likelihood (division
events, cell variability, population-average data scoring) at a
realistic population size under batched evaluation on the GPU, measure
evals/sec, and capture a profiler trace to locate the hot spot.

The model is a dividing cell with a stiff kinase/phosphatase module
(rates ~1e3 vs growth ~1e-1, the stiffness regime the reference uses
CVODE for) and Sobol cell-to-cell variability on the division clock —
a scaled-down analogue of the reference's cell-cycle models
(reference: src/cellpop/Experiment.cpp:635-846).

Usage:
  python tools/bench_cellpop.py [--cells 128] [--batch 64] [--profile DIR]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SBML_NS = "http://www.sbml.org/sbml/level2/version4"
MATHML = "http://www.w3.org/1998/Math/MathML"

CELL_MODEL = f"""<?xml version="1.0"?>
<sbml xmlns="{SBML_NS}" level="2" version="4">
<model id="cell">
<listOfSpecies>
  <species id="mass" name="mass" initialAmount="1.0"/>
  <species id="cytokinesis" name="cytokinesis" initialAmount="0.0"/>
  <species id="Ka" name="Ka" initialAmount="0.0"/>
  <species id="Xp" name="Xp" initialAmount="0.0"/>
  <species id="env" name="env" initialAmount="1.0"/>
</listOfSpecies>
<listOfParameters>
  <parameter id="Ktot" value="1.0"/>
  <parameter id="Xtot" value="1.0"/>
  <parameter id="k_act" value="2000.0"/>
  <parameter id="k_deact" value="1000.0"/>
  <parameter id="k_phos" value="3000.0"/>
  <parameter id="k_dephos" value="1500.0"/>
</listOfParameters>
<listOfReactions>
  <reaction id="growth">
    <listOfProducts><speciesReference species="mass"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_growth</ci><ci>mass</ci>
        <apply><minus/><cn>1</cn><ci>Xp</ci></apply></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="division_clock">
    <listOfProducts><speciesReference species="cytokinesis"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}"><ci>k_div</ci></math></kineticLaw>
  </reaction>
  <reaction id="k_activation">
    <listOfProducts><speciesReference species="Ka"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_act</ci><ci>mass</ci>
        <apply><minus/><ci>Ktot</ci><ci>Ka</ci></apply></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="k_deactivation">
    <listOfReactants><speciesReference species="Ka"/></listOfReactants>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_deact</ci><ci>Ka</ci></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="x_phos">
    <listOfProducts><speciesReference species="Xp"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_phos</ci><ci>Ka</ci>
        <apply><minus/><ci>Xtot</ci><ci>Xp</ci></apply></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="x_dephos">
    <listOfReactants><speciesReference species="Xp"/></listOfReactants>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_dephos</ci><ci>Xp</ci></apply>
    </math></kineticLaw>
  </reaction>
</listOfReactions>
</model>
</sbml>
"""


def build_likelihood(max_cells: int, num_cells: int, solver: str, trips,
                     variability: bool = True, divide: bool = True):
    import h5py
    import numpy as np

    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.variables import VariableSet

    d = tempfile.mkdtemp(prefix="cellpop_bench_")
    with open(os.path.join(d, "cell.xml"), "w") as f:
        f.write(CELL_MODEL)

    times = np.linspace(0.5, 10.0, 12)
    k_growth = 0.1
    obs = np.exp(k_growth * 0.6 * times)[None, :]
    with h5py.File(os.path.join(d, "data.nc"), "w") as f:
        g = f.create_group("exp1")
        g.create_dataset("time", data=times)
        g.create_dataset("avg_mass", data=obs)

    trips_attr = f' solver_trips="{trips}"' if trips else ""
    cv_block = (
        '  <cell_variability distribution="diagonal_gaussian">\n'
        '    <variable model_parameter="k_div" apply="multiplicative_log"'
        ' scale="cv_kdiv"/>\n'
        "  </cell_variability>\n"
    ) if variability else ""
    with open(os.path.join(d, "likelihood.xml"), "w") as f:
        f.write(
            '<bcm_likelihood type="cell_population">\n'
            f'<experiment name="exp1" model_file="cell.xml" data_file="data.nc"\n'
            f'  num_cells="{num_cells}" max_cells="{max_cells}" divide_cells="{str(divide).lower()}"'
            ' entry_time="0"\n'
            f'  solver_type="{solver}" solver_relative_tolerance="1e-6"\n'
            f'  solver_absolute_tolerance="1e-6"{trips_attr}'
            ' trailing_simulation_time="0.5">\n'
            + cv_block +
            '  <data type="time_course_population_average" data_name="avg_mass"\n'
            '    species_name="mass" error_model="normal" stdev="sd"/>\n'
            "</experiment>\n"
            "</bcm_likelihood>\n"
        )

    vs = VariableSet()
    vs.add_variable("k_growth")
    vs.add_variable("k_div")
    vs.add_variable("cv_kdiv")
    vs.add_variable("sd")
    lik = create_likelihood(os.path.join(d, "likelihood.xml"), vs)
    return lik


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=128)
    ap.add_argument("--num-cells", type=int, default=16)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--solver", default="CVODE")
    ap.add_argument("--trips", type=int, default=0)
    ap.add_argument("--profile", default="")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    from bcm3_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    lik = build_likelihood(args.cells, args.num_cells, args.solver, args.trips)
    base = jnp.asarray([0.1, 0.25, 0.15, 0.05])
    key = jax.random.PRNGKey(0)
    xs = base[None, :] * jnp.exp(
        0.05 * jax.random.normal(key, (args.batch, 4), dtype=base.dtype)
    )

    f = jax.jit(jax.vmap(lik.log_prob))
    t0 = time.time()
    out = np.asarray(f(xs))
    print(f"compile+first: {time.time()-t0:.1f}s  finite "
          f"{int(np.isfinite(out).sum())}/{args.batch}")

    if args.profile:
        with jax.profiler.trace(args.profile):
            out = np.asarray(f(xs))
        print("profile trace written to", args.profile)

    t0 = time.time()
    for _ in range(args.reps):
        out = f(xs)
    np.asarray(out)
    dt = (time.time() - t0) / args.reps
    print(
        f"cellpop evals/s: {args.batch/dt:.2f}  "
        f"({dt*1e3/args.batch:.2f} ms/eval, batch={args.batch}, "
        f"max_cells={args.cells}, solver={args.solver}, trips={args.trips})"
    )


if __name__ == "__main__":
    main()
