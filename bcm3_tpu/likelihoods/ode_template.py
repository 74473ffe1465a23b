"""Template ODE likelihood with a pluggable JAX right-hand side.

JAX equivalent of the reference's LikelihoodODE example/template
(reference: src/likelihoods/LikelihoodODE.cpp:14-82): 13 inference
variables, a 4-state ODE whose initial conditions are parameters 9-12,
trajectories at 100 timepoints over [0, 1000], and the first state
compared against 100*cos(t/2300)+300 with Student-t(nu=3, sd=10) errors.

The reference ships an *empty* derivative stub for users to fill in
(LikelihoodODE.cpp CalculateDerivative:75-82); here the derivative is a
constructor argument — any jittable ``f(t, y, params) -> dy/dt`` — with
the same do-nothing default. Where the reference integrates with CVODE
one trajectory at a time on the host, this evaluates the whole chain
population through one vmapped adaptive DP5 solve.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from bcm3_tpu.distributions.univariate import logpdf_t
from bcm3_tpu.model.variables import VariableSet
from bcm3_tpu.ode.dp5 import solve_at_times


def _zero_derivative(t, y, params):
    """The reference template's derivative is an empty stub the user must
    fill in (reference: LikelihoodODE.cpp:75-82); dy/dt = 0 reproduces its
    behavior exactly (dydt never written => trajectories constant)."""
    return jnp.zeros_like(y)


class ODETemplateLikelihood:
    """``params -> logp`` for the reference ODE example model."""

    NUM_DYNAMIC = 4
    NUM_INFERENCE = 13

    def __init__(
        self,
        varset: VariableSet,
        derivative: Optional[Callable] = None,
        rtol: float = 1e-8,
        atol: float = 1e-8,
    ):
        if varset.num_variables != self.NUM_INFERENCE:
            raise ValueError(
                "Incorrect number of parameters "
                f"(reference requires {self.NUM_INFERENCE}, "
                f"got {varset.num_variables})"
            )
        self.varset = varset
        self.derivative = derivative or _zero_derivative
        self.rtol = rtol
        self.atol = atol
        # 100 timepoints over [0, 1000] (reference: LikelihoodODE.cpp:36-42)
        self.timepoints = np.linspace(0.0, 1000.0, 100)
        self._transforms = np.asarray(varset.transforms)

    def _transform(self, values):
        """Per-variable output transforms (reference applies
        varset->TransformVariable, LikelihoodODE.cpp:49-51)."""
        t = jnp.asarray(self._transforms)
        x = values
        x = jnp.where(t == 1, jnp.exp(values), x)
        x = jnp.where(t == 2, jnp.power(10.0, values), x)
        x = jnp.where(t == 3, 1.0 / (1.0 + jnp.exp(-values)), x)
        return x

    def simulate(self, values):
        """Integrate and return trajectories (S=100, 4)."""
        p = self._transform(values)
        y0 = p[9:13]  # initial conditions are parameters 9..12
        ts = jnp.asarray(self.timepoints, dtype=values.dtype)
        res = solve_at_times(
            self.derivative, y0, ts, args=p, rtol=self.rtol, atol=self.atol
        )
        return res.ys, res.ok

    def log_prob(self, values):
        ys, ok = self.simulate(values)
        ts = jnp.asarray(self.timepoints, dtype=values.dtype)
        data = 100.0 * jnp.cos(ts / 2300.0) + 300.0
        # Student-t nu=3, sd=10 on the first dynamic variable
        # (reference: LikelihoodODE.cpp:62-67 with LogPdfTnu3)
        pointwise = logpdf_t(data, ys[:, 0], 10.0, 3.0)
        logp = jnp.sum(pointwise)
        return jnp.where(ok & jnp.isfinite(logp), logp, -jnp.inf)
