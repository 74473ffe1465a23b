"""Rate-law AST -> jittable JAX expression compiler.

JAX replacement for the reference's dual interpret/codegen path
(reference: src/sbml/SBMLRatelaws.cpp: the Evaluate virtuals interpret
the AST per CVODE step; GenerateEquation emits C++ source compiled via
cmake and dlopen'd, SolverCodeGenerator.cpp:32-120). Under XLA neither
is needed: the AST is compiled ONCE into a jnp expression inside the
traced RHS, and XLA's JIT is the code generator. Jacobians come from
``jax.jacfwd`` instead of the reference's per-entry symbolic
differentiation (SBMLModel.cpp GenerateJacobianCode).

Special functions, matching the reference exactly
(SBMLRatelaws.cpp:6-77):
- hill(x, k, n) = x^n / (k^n + x^n)
- mm(kcat, KM, e, s): 0 if e <= 0; kcat*e*s/KM if s < 0;
  kcat*e*s/(KM+s) otherwise
- synthcap(x) = 0 if x < 0 else 1 - x^8
- tQSSA(k, km, e, s) = 0.5*k*(E - sqrt(E^2 - 4*e*s)), E = e+km+s
- pow is "safepow": 0 for negative base (SBMLRatelaws.cpp:40-47)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax.numpy as jnp

from bcm3_tpu.sbml.parser import SBMLDocument


def hill(x, k, n):
    xn = jnp.power(x, n)
    kn = jnp.power(k, n)
    return xn / (kn + xn)


def michaelis_menten(kcat, km, e, s):
    pos = kcat * e * s / (km + s)
    neg = kcat * e * s / km
    val = jnp.where(s < 0, neg, pos)
    return jnp.where(e <= 0, 0.0, val)


def synthcap(x):
    x2 = x * x
    x8 = (x2 * x2) * (x2 * x2)
    return jnp.where(x < 0, 0.0, 1.0 - x8)


def tqssa(k, km, e, s):
    ekms = e + km + s
    return 0.5 * k * (ekms - jnp.sqrt(ekms * ekms - 4.0 * e * s))


def safepow(x, n):
    # reference zeroes negative bases to avoid NaNs from fractional powers
    return jnp.where(x < 0, 0.0, jnp.power(jnp.maximum(x, 0.0), n))


class RatelawCompiler:
    """Compile ASTs with the reference's name-resolution priority
    (reference: SBMLRatelaws.cpp AST_NAME:152-221): fixed parameter
    values > inference parameters > ODE species > constant species >
    non-sampled parameters > SBML document parameter values."""

    def __init__(
        self,
        doc: SBMLDocument,
        species_index: Dict[str, int],
        parameter_index: Dict[str, int],
        constant_species_index: Dict[str, int],
        non_sampled_index: Dict[str, int],
        fixed_values: Optional[Dict[str, float]] = None,
    ):
        self.doc = doc
        self.species_index = species_index
        self.parameter_index = parameter_index
        self.constant_species_index = constant_species_index
        self.non_sampled_index = non_sampled_index
        self.fixed_values = fixed_values or {}

    def compile(self, ast) -> Callable:
        """AST -> f(t, y, constant_y, params, nsp) returning a scalar."""
        expr = self._build(ast, {})

        def f(t, y, constant_y, params, nsp):
            return expr(t, y, constant_y, params, nsp)

        return f

    def _build(self, ast, bound: Dict[str, Callable]):
        kind = ast[0]
        if kind == "const":
            v = ast[1]
            return lambda t, y, c, p, n: v
        if kind == "name":
            return self._resolve_name(ast[1], bound)
        if kind == "call":
            return self._build_call(ast[1], ast[2], bound)
        args = [self._build(a, bound) for a in ast[1]]
        if kind == "+":
            return lambda t, y, c, p, n: sum(
                (a(t, y, c, p, n) for a in args[1:]), args[0](t, y, c, p, n)
            )
        if kind == "*":
            def times(t, y, c, p, n):
                out = args[0](t, y, c, p, n)
                for a in args[1:]:
                    out = out * a(t, y, c, p, n)
                return out

            return times
        if kind == "-":
            a, b = args
            return lambda t, y, c, p, n: a(t, y, c, p, n) - b(t, y, c, p, n)
        if kind == "neg":
            (a,) = args
            return lambda t, y, c, p, n: -a(t, y, c, p, n)
        if kind == "/":
            a, b = args
            return lambda t, y, c, p, n: a(t, y, c, p, n) / b(t, y, c, p, n)
        if kind == "pow":
            a, b = args
            return lambda t, y, c, p, n: safepow(
                a(t, y, c, p, n), b(t, y, c, p, n)
            )
        if kind == "exp":
            (a,) = args
            return lambda t, y, c, p, n: jnp.exp(a(t, y, c, p, n))
        if kind == "ln":
            (a,) = args
            return lambda t, y, c, p, n: jnp.log(a(t, y, c, p, n))
        if kind == "log10":
            (a,) = args
            return lambda t, y, c, p, n: jnp.log10(a(t, y, c, p, n))
        if kind == "sqrt":
            (a,) = args
            return lambda t, y, c, p, n: jnp.sqrt(a(t, y, c, p, n))
        raise ValueError(f"Unsupported AST node '{kind}'")

    def _resolve_name(self, name: str, bound: Dict[str, Callable]):
        if name in bound:
            return bound[name]
        if name == "__time__":
            return lambda t, y, c, p, n: t
        if name in self.fixed_values:
            v = float(self.fixed_values[name])
            return lambda t, y, c, p, n: v
        if name in self.parameter_index:
            ix = self.parameter_index[name]
            return lambda t, y, c, p, n: p[ix]
        if name in self.species_index:
            ix = self.species_index[name]
            return lambda t, y, c, p, n: y[ix]
        if name in self.constant_species_index:
            ix = self.constant_species_index[name]
            return lambda t, y, c, p, n: c[ix]
        if name in self.non_sampled_index:
            ix = self.non_sampled_index[name]
            return lambda t, y, c, p, n: n[ix]
        if name in self.doc.parameters:
            v = float(self.doc.parameters[name])
            return lambda t, y, c, p, n: v
        raise ValueError(
            f"Name '{name}' does not map to a species or parameter"
        )

    def _build_call(self, fname: str, arg_asts, bound: Dict[str, Callable]):
        args = [self._build(a, bound) for a in arg_asts]
        if fname == "hill":
            if len(args) != 3:
                raise ValueError("hill function should have three parameters")
            x, k, n_ = args
            return lambda t, y, c, p, n: hill(
                x(t, y, c, p, n), k(t, y, c, p, n), n_(t, y, c, p, n)
            )
        if fname == "mm":
            if len(args) != 4:
                raise ValueError("mm function should have four parameters")
            kc, km, e, s = args
            return lambda t, y, c, p, n: michaelis_menten(
                kc(t, y, c, p, n),
                km(t, y, c, p, n),
                e(t, y, c, p, n),
                s(t, y, c, p, n),
            )
        if fname == "synthcap":
            if len(args) != 1:
                raise ValueError("synthcap function should have one parameter")
            (x,) = args
            return lambda t, y, c, p, n: synthcap(x(t, y, c, p, n))
        if fname == "tQSSA":
            if len(args) != 4:
                raise ValueError("tQSSA function should have four parameters")
            k_, km, e, s = args
            return lambda t, y, c, p, n: tqssa(
                k_(t, y, c, p, n),
                km(t, y, c, p, n),
                e(t, y, c, p, n),
                s(t, y, c, p, n),
            )
        if fname == "pow":
            a, b = args
            return lambda t, y, c, p, n: safepow(
                a(t, y, c, p, n), b(t, y, c, p, n)
            )
        # user function definition: inline the body with bound arguments
        if fname in self.doc.functions:
            fdef = self.doc.functions[fname]
            if len(args) != len(fdef.arg_names):
                raise ValueError(
                    f"Function {fname} expects {len(fdef.arg_names)} args"
                )
            inner_bound = dict(bound)
            inner_bound.update(dict(zip(fdef.arg_names, args)))
            return self._build(fdef.body, inner_bound)
        raise ValueError(f"Unknown function '{fname}' in rate law")
