"""Stiff-solver parity study: RODAS3 vs BDF on a stiff SBML model.

VERDICT r1 item 5: benchmark the framework's L-stable Rosenbrock solver
(bcm3_tpu/ode/rosenbrock.py, the replacement for the reference's CVODE
BDF wrapper, src/odecommon/ODESolverCVODE.cpp:322-445) against a
CVODE-class oracle (scipy.integrate.solve_ivp BDF) on a realistically
stiff signaling model built through the real SBML -> JAX path
(bcm3_tpu/sbml), at the reference's cellpop tolerances
(4 * float32-eps rel/abs, src/cellpop/Experiment.cpp:58-59).

The model is a kinase cascade with a fast phosphorylation/
dephosphorylation cycle (rates ~1e3) under slow synthesis/degradation
(~1e-2): stiffness ratio ~1e5, the regime where explicit solvers blow
up and the reference reaches for CVODE.

On the Jacobian: the reference generates per-entry Jacobian source code
from the SBML AST (src/sbml/SBMLModel.h:28-30) because its alternative
is CVODE's finite-difference quotients. Here `jax.jacfwd` of the traced
RHS IS the analytic Jacobian — forward-mode autodiff of a closed-form
expression graph is exact to rounding and XLA fuses/CSEs it with the RHS
evaluation, so a separate symbolic-codegen path would duplicate what the
compiler already produces (`SBMLModel.make_jacobian` wraps exactly this).

Run: python tools/stiff_parity.py  (CPU, float64; prints a markdown table)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from scipy.integrate import solve_ivp

from bcm3_tpu.sbml import SBMLModel

SBML_NS = "http://www.sbml.org/sbml/level2/version4"
MATHML = "http://www.w3.org/1998/Math/MathML"

# Species: S (signal), Ka (active kinase), Xp (phospho-substrate),
# O (output). Conservation handled with explicit totals as parameters.
MODEL = f"""<?xml version="1.0" encoding="UTF-8"?>
<sbml xmlns="{SBML_NS}" level="2" version="4">
<model id="stiff_cascade">
<listOfSpecies>
  <species id="S" name="S" initialAmount="0.0"/>
  <species id="Ka" name="Ka" initialAmount="0.0"/>
  <species id="Xp" name="Xp" initialAmount="0.0"/>
  <species id="O" name="O" initialAmount="0.0"/>
</listOfSpecies>
<listOfParameters>
  <parameter id="Ktot" value="1.0"/>
  <parameter id="Xtot" value="1.0"/>
  <parameter id="KO" value="0.25"/>
</listOfParameters>
<listOfReactions>
  <reaction id="r_s_syn">
    <listOfProducts><speciesReference species="S"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}"><ci>k_syn</ci></math></kineticLaw>
  </reaction>
  <reaction id="r_s_deg">
    <listOfReactants><speciesReference species="S"/></listOfReactants>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_deg</ci><ci>S</ci></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="r_k_act">
    <listOfProducts><speciesReference species="Ka"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_act</ci><ci>S</ci>
        <apply><minus/><ci>Ktot</ci><ci>Ka</ci></apply></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="r_k_deact">
    <listOfReactants><speciesReference species="Ka"/></listOfReactants>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_deact</ci><ci>Ka</ci></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="r_x_phos">
    <listOfProducts><speciesReference species="Xp"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_phos</ci><ci>Ka</ci>
        <apply><minus/><ci>Xtot</ci><ci>Xp</ci></apply></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="r_x_dephos">
    <listOfReactants><speciesReference species="Xp"/></listOfReactants>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_dephos</ci><ci>Xp</ci></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="r_o_syn">
    <listOfProducts><speciesReference species="O"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_osyn</ci>
        <apply><ci>hill</ci><ci>Xp</ci><ci>KO</ci><cn>4</cn></apply>
      </apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="r_o_deg">
    <listOfReactants><speciesReference species="O"/></listOfReactants>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_odeg</ci><ci>O</ci></apply>
    </math></kineticLaw>
  </reaction>
</listOfReactions>
</model>
</sbml>
"""

PARAM_NAMES = [
    "k_syn", "k_deg", "k_act", "k_deact", "k_phos", "k_dephos",
    "k_osyn", "k_odeg",
]
# slow synthesis/degradation, fast (1e3) kinase & phosphatase cycles:
# stiffness ratio ~1e5
P0 = np.array([0.02, 0.03, 2e3, 1e3, 3e3, 1.5e3, 0.5, 0.05])

T_END = 200.0
N_OUT = 50
REF_TOL = 4 * np.finfo(np.float32).eps  # reference cellpop default


def main():
    m = SBMLModel.from_string(MODEL)
    rhs = m.make_rhs(PARAM_NAMES)
    c = jnp.zeros(0)
    nsp = jnp.zeros(0)
    y0 = np.zeros(4)
    ts = np.linspace(0.0, T_END, N_OUT + 1)

    def f_np(t, y, p):
        return np.asarray(rhs(t, jnp.asarray(y), c, jnp.asarray(p), nsp))

    # tight-tolerance oracle
    oracle = solve_ivp(
        f_np, (0, T_END), y0, t_eval=ts, args=(P0,), method="BDF",
        rtol=1e-10, atol=1e-13,
    )
    assert oracle.success
    y_ref = oracle.y.T  # (N+1, 4)
    scale = np.abs(y_ref).max(0) + 1e-12

    rows = []

    # scipy BDF at reference tolerance (the CVODE-class contender)
    t0 = time.time()
    sol = solve_ivp(
        f_np, (0, T_END), y0, t_eval=ts, args=(P0,), method="BDF",
        rtol=REF_TOL, atol=REF_TOL,
    )
    wall = time.time() - t0
    err = np.abs(sol.y.T - y_ref) / scale
    rows.append(("scipy BDF (CVODE-class)", sol.nfev, err.max(), wall, 1))

    from bcm3_tpu.ode.rosenbrock import solve_at_times_stiff

    def run_rodas(fixed_trips, label, batch=256):
        tsj = jnp.asarray(ts)

        def deriv(t, y, args):
            return rhs(t, y, c, args, nsp)

        def solve(p):
            return solve_at_times_stiff(
                deriv, jnp.asarray(y0), tsj, args=p,
                rtol=REF_TOL, atol=REF_TOL, fixed_trips=fixed_trips,
            )

        one = jax.jit(solve)
        res = one(jnp.asarray(P0))
        steps = int(res.n_steps)
        ok = bool(res.ok)
        err = np.abs(np.asarray(res.ys) - y_ref) / scale

        # batched wall-clock: vmap over `batch` jittered parameter sets
        pb = jnp.asarray(P0)[None, :] * jnp.exp(
            0.05 * jax.random.normal(jax.random.PRNGKey(0), (batch, len(P0)))
        )
        fb = jax.jit(jax.vmap(lambda p: solve(p).ys[-1]))
        out = np.asarray(fb(pb))  # compile (+ true sync)
        t0 = time.time()
        reps = 5
        for _ in range(reps):
            out = fb(pb)
        jax.block_until_ready(out)
        wall_batched = (time.time() - t0) / reps / batch
        rows.append((label, steps, err.max(), wall_batched, batch))
        return ok

    ok1 = run_rodas(None, "RODAS3 (adaptive while)")
    ok2 = run_rodas(2048, "RODAS3 (static 2048-trip fori)")

    print(f"\nstiff cascade, t=[0,{T_END:g}], {N_OUT} outputs, "
          f"tol rel=abs={REF_TOL:.2e} (reference cellpop default)")
    print("| solver | steps/nfev | max rel err vs 1e-10 oracle | "
          "wall per trajectory | batch |")
    print("|---|---|---|---|---|")
    for label, steps, e, w, b in rows:
        print(f"| {label} | {steps} | {e:.2e} | {w*1e3:.3f} ms | {b} |")
    print(f"\nRODAS3 ok flags: adaptive={ok1} fori={ok2}")


if __name__ == "__main__":
    main()
