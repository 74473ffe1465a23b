"""Cellpop scaling benches: species count and Hungarian-matched scoring.

VERDICT r3 item 4: the 5-species bench says little about reference-shaped
cell-cycle models (tens of species, per-cell Hungarian-matched time
courses — src/cellpop/DataLikelihoodTimeCourse.cpp, SBMLModel.h:28-30).
Two unknowns sit between the small bench and a real model:

1. the O(S^3) LU growth of the batched Rosenbrock step with species
   count — measured here with auto-generated stiff kinase-cascade SBML
   models of 5 / 21 / 41 species (each extra module adds a (Ka_i, Xp_i)
   pair with rates ~1e3, driven by the previous module's output, so the
   stiffness structure of the base model is preserved as it grows);
2. the host-side Hungarian matching cost of per-cell time-course scoring
   (DataLikelihoodTimeCourse + native/lap.cpp) vs population-average
   scoring — measured here on the same base model with a per-cell
   observed matrix.

Usage:
  python tools/bench_cellpop_scaling.py [--batch 128] [--modules 0 8 18]
  python tools/bench_cellpop_scaling.py --matched-only [--batch 128]

Prints one JSON line per configuration.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# keep the Rosenbrock step on the unrolled LU for the larger models
os.environ.setdefault("BCM3_SMALL_LU_MAX", "48")

SBML_NS = "http://www.sbml.org/sbml/level2/version4"
MATHML = "http://www.w3.org/1998/Math/MathML"


def _reaction(rid, products, reactants, math):
    prods = "".join(
        f'<speciesReference species="{s}"/>' for s in products
    )
    reacts = "".join(
        f'<speciesReference species="{s}"/>' for s in reactants
    )
    plist = f"<listOfProducts>{prods}</listOfProducts>" if prods else ""
    rlist = f"<listOfReactants>{reacts}</listOfReactants>" if reacts else ""
    return (
        f'<reaction id="{rid}">{rlist}{plist}'
        f'<kineticLaw><math xmlns="{MATHML}">{math}</math></kineticLaw>'
        "</reaction>"
    )


def cascade_model(extra_modules: int) -> str:
    """Dividing-cell model with a stiff kinase cascade of
    ``extra_modules`` additional (Ka_i, Xp_i) modules; 5 + 2*m species.

    Module i's kinase is activated by the previous module's output
    (module 0 by mass), with the same ~1e3 rates as the base model, so
    the stiffness ratio is preserved while the Jacobian grows."""
    species = [
        '<species id="mass" name="mass" initialAmount="1.0"/>',
        '<species id="cytokinesis" name="cytokinesis" initialAmount="0.0"/>',
        '<species id="Ka" name="Ka" initialAmount="0.0"/>',
        '<species id="Xp" name="Xp" initialAmount="0.0"/>',
        '<species id="env" name="env" initialAmount="1.0"/>',
    ]
    reactions = [
        _reaction(
            "growth", ["mass"], [],
            "<apply><times/><ci>k_growth</ci><ci>mass</ci>"
            "<apply><minus/><cn>1</cn><ci>Xp</ci></apply></apply>",
        ),
        _reaction(
            "division_clock", ["cytokinesis"], [], "<ci>k_div</ci>"
        ),
        _reaction(
            "k_activation", ["Ka"], [],
            "<apply><times/><ci>k_act</ci><ci>mass</ci>"
            "<apply><minus/><ci>Ktot</ci><ci>Ka</ci></apply></apply>",
        ),
        _reaction(
            "k_deactivation", [], ["Ka"],
            "<apply><times/><ci>k_deact</ci><ci>Ka</ci></apply>",
        ),
        _reaction(
            "x_phos", ["Xp"], [],
            "<apply><times/><ci>k_phos</ci><ci>Ka</ci>"
            "<apply><minus/><ci>Xtot</ci><ci>Xp</ci></apply></apply>",
        ),
        _reaction(
            "x_dephos", [], ["Xp"],
            "<apply><times/><ci>k_dephos</ci><ci>Xp</ci></apply>",
        ),
    ]
    for i in range(extra_modules):
        ka, xp = f"Ka{i}", f"Xp{i}"
        driver = "mass" if i == 0 else f"Xp{i - 1}"
        species.append(f'<species id="{ka}" initialAmount="0.0"/>')
        species.append(f'<species id="{xp}" initialAmount="0.0"/>')
        reactions.append(
            _reaction(
                f"k_act_{i}", [ka], [],
                f"<apply><times/><ci>k_act</ci><ci>{driver}</ci>"
                f"<apply><minus/><ci>Ktot</ci><ci>{ka}</ci></apply></apply>",
            )
        )
        reactions.append(
            _reaction(
                f"k_deact_{i}", [], [ka],
                f"<apply><times/><ci>k_deact</ci><ci>{ka}</ci></apply>",
            )
        )
        reactions.append(
            _reaction(
                f"x_phos_{i}", [xp], [],
                f"<apply><times/><ci>k_phos</ci><ci>{ka}</ci>"
                f"<apply><minus/><ci>Xtot</ci><ci>{xp}</ci></apply></apply>",
            )
        )
        reactions.append(
            _reaction(
                f"x_dephos_{i}", [], [xp],
                f"<apply><times/><ci>k_dephos</ci><ci>{xp}</ci></apply>",
            )
        )
    params = (
        '<parameter id="Ktot" value="1.0"/>'
        '<parameter id="Xtot" value="1.0"/>'
        '<parameter id="k_act" value="2000.0"/>'
        '<parameter id="k_deact" value="1000.0"/>'
        '<parameter id="k_phos" value="3000.0"/>'
        '<parameter id="k_dephos" value="1500.0"/>'
    )
    return (
        f'<?xml version="1.0"?>\n<sbml xmlns="{SBML_NS}" level="2"'
        ' version="4">\n<model id="cell">\n'
        f"<listOfSpecies>{''.join(species)}</listOfSpecies>\n"
        f"<listOfParameters>{params}</listOfParameters>\n"
        f"<listOfReactions>{''.join(reactions)}</listOfReactions>\n"
        "</model>\n</sbml>\n"
    )


def build_likelihood(extra_modules: int, max_cells: int, num_cells: int,
                     matched: bool):
    import h5py
    import numpy as np

    from bcm3_tpu.likelihoods import create_likelihood
    from bcm3_tpu.model.variables import VariableSet

    d = tempfile.mkdtemp(prefix="cellpop_scaling_")
    with open(os.path.join(d, "cell.xml"), "w") as f:
        f.write(cascade_model(extra_modules))

    times = np.linspace(0.5, 10.0, 12)
    k_growth = 0.1
    with h5py.File(os.path.join(d, "data.nc"), "w") as f:
        g = f.create_group("exp1")
        g.create_dataset("time", data=times)
        if matched:
            # per-cell observed time courses (the Hungarian-matched
            # scoring path): one trace per observed cell, with spread
            rng = np.random.default_rng(3)
            n_obs = num_cells
            base = np.exp(k_growth * 0.6 * times)[None, :]
            obs = base * rng.lognormal(0.0, 0.15, size=(n_obs, 1))
            g.create_dataset("cell_mass", data=obs)
        else:
            obs = np.exp(k_growth * 0.6 * times)[None, :]
            g.create_dataset("avg_mass", data=obs)

    data_block = (
        '  <data type="time_course" data_name="cell_mass"\n'
        '    species_name="mass" error_model="normal" stdev="sd"/>\n'
        if matched
        else
        '  <data type="time_course_population_average" data_name="avg_mass"\n'
        '    species_name="mass" error_model="normal" stdev="sd"/>\n'
    )
    with open(os.path.join(d, "likelihood.xml"), "w") as f:
        f.write(
            '<bcm_likelihood type="cell_population">\n'
            '<experiment name="exp1" model_file="cell.xml"'
            ' data_file="data.nc"\n'
            f'  num_cells="{num_cells}" max_cells="{max_cells}"'
            ' divide_cells="true" entry_time="0"\n'
            '  solver_type="CVODE" solver_relative_tolerance="1e-6"\n'
            '  solver_absolute_tolerance="1e-6"'
            ' trailing_simulation_time="0.5">\n'
            '  <cell_variability distribution="diagonal_gaussian">\n'
            '    <variable model_parameter="k_div"'
            ' apply="multiplicative_log" scale="cv_kdiv"/>\n'
            "  </cell_variability>\n"
            + data_block +
            "</experiment>\n"
            "</bcm_likelihood>\n"
        )

    vs = VariableSet()
    for name in ("k_growth", "k_div", "cv_kdiv", "sd"):
        vs.add_variable(name)
    return create_likelihood(os.path.join(d, "likelihood.xml"), vs)


def bench_one(lik, batch: int, reps: int, matched: bool = False):
    import jax
    import jax.numpy as jnp
    import numpy as np

    base = jnp.asarray([0.1, 0.25, 0.15, 0.05])
    xs = base[None, :] * jnp.exp(
        0.05 * jax.random.normal(jax.random.PRNGKey(0), (batch, 4),
                                 base.dtype)
    )
    if matched:
        # two-phase path: device cost matrices + host LAP (lik.log_prob
        # runs the matching in-graph instead). The host matching is
        # timed INSIDE the loop — it is part of the evaluation.
        f = lik.model.log_prob_batch_hostmatch
    else:
        f = jax.jit(jax.vmap(lik.log_prob))
    t0 = time.time()
    out = np.asarray(f(xs))
    compile_s = time.time() - t0
    finite = int(np.isfinite(out).sum())
    t0 = time.time()
    for _ in range(reps):
        out = f(xs)
    np.asarray(out)
    dt = (time.time() - t0) / reps
    return {
        "evals_per_sec": round(batch / dt, 2),
        "ms_per_eval": round(dt * 1e3 / batch, 3),
        "finite": finite,
        "compile_s": round(compile_s, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--cells", type=int, default=128)
    ap.add_argument("--num-cells", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--modules", type=int, nargs="*", default=[0, 8, 18])
    ap.add_argument("--matched-only", action="store_true")
    ap.add_argument("--skip-matched", action="store_true")
    ap.add_argument("--matched-modules", type=int, default=0)
    args = ap.parse_args()

    import jax

    from bcm3_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    if not args.matched_only:
        for m in args.modules:
            lik = build_likelihood(m, args.cells, args.num_cells,
                                   matched=False)
            r = bench_one(lik, args.batch, args.reps)
            print(json.dumps({
                "config": "species_scaling",
                "species": 5 + 2 * m,
                "scoring": "population_average",
                "batch": args.batch,
                **r,
            }), flush=True)

    if not args.skip_matched:
        m = args.matched_modules
        lik = build_likelihood(m, args.cells, args.num_cells, matched=True)
        r = bench_one(lik, args.batch, args.reps, matched=True)
        print(json.dumps({
            "config": "matched_scoring",
            "species": 5 + 2 * m,
            "scoring": "hungarian_time_course",
            "batch": args.batch,
            **r,
        }), flush=True)


if __name__ == "__main__":
    main()
