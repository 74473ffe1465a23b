"""bcm3_tpu: Bayesian inference for simulation-based likelihoods in JAX.

A from-scratch re-expression of the capabilities of BCM3 (reference:
NKI-CCB/bcm3, C++/R) as an idiomatic JAX/XLA framework:

- parallel-tempered Metropolis-Hastings with adaptive Gaussian-mixture /
  global-covariance / clustered-covariance proposals (reference:
  src/sampler/SamplerPT.cpp, Proposal*.cpp), with every tempered chain
  advanced in a single jit-compiled, vmapped device step;
- a likelihood library (analytic test targets, ODE-based pharmacokinetic
  population models, heterogeneous cell populations) expressed as pure
  `params -> logp` functions batched over chains with `vmap`
  (reference: src/likelihoods/*);
- batched ODE integrators replacing CVODE (reference: src/odecommon/*);
- chains/temperatures sharded over a `jax.sharding.Mesh` with XLA
  collectives replacing the reference's pthread TaskManager
  (reference: src/utils/TaskManager.h);
- an HDF5 sample store whose layout is readable by the reference's R
  analysis scripts (reference: src/sampler/SampleHandlerNetCDF.cpp,
  R/load.r).
"""

__version__ = "0.1.0"

from bcm3_tpu.model.variables import VariableSet
from bcm3_tpu.model.prior import Prior
from bcm3_tpu.likelihoods import create_likelihood

__all__ = [
    "VariableSet",
    "Prior",
    "create_likelihood",
    "__version__",
]
