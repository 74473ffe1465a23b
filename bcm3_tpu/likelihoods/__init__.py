"""Likelihood registry: string type -> pure JAX log-density factory.

JAX equivalent of the reference factory
(reference: src/likelihoods/LikelihoodFactory.cpp:31-101). A likelihood
is a pure function ``params -> logp`` (plus optional auxiliary outputs),
configured from the same ``likelihood.xml`` schema the reference uses.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import numpy as np

from bcm3_tpu.likelihoods import analytic
from bcm3_tpu.model.variables import VariableSet


@dataclass
class Likelihood:
    """A likelihood: pure ``log_prob(params) -> scalar`` JAX function.

    ``log_prob`` must be traceable under jit/vmap. ``learning_rate``
    tempers the likelihood like the reference's Likelihood::SetLearningRate.
    """

    name: str
    log_prob: Callable[[Any], Any]
    learning_rate: float = 1.0
    attrs: Dict[str, str] = field(default_factory=dict)
    model: Any = None  # backing model object (e.g. PopPKLikelihood)
    # optional natively batched evaluation `xs (B, D) -> (B,)`; samplers
    # use it instead of vmap(log_prob) when present (e.g. the PopPK
    # transit kernel)
    log_prob_batched: Any = None


def parse_vector(s: str) -> np.ndarray:
    """Parse 'a;b;c' vectors (reference: src/utils/VectorUtils.cpp:255)."""
    return np.array([float(v) for v in s.split(";") if v.strip() != ""])


def parse_matrix(s: str) -> np.ndarray:
    """Parse 'a,b;c,d' row-major matrices (reference: src/utils/VectorUtils.cpp)."""
    rows = [r for r in s.split(";") if r.strip() != ""]
    return np.array([[float(v) for v in r.split(",")] for r in rows])


_REGISTRY: Dict[str, Callable[..., Likelihood]] = {}


def register_likelihood(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def available_likelihoods():
    return sorted(_REGISTRY)


def create_likelihood(
    filename_or_type: str, varset: VariableSet, **kwargs
) -> Likelihood:
    """Create a likelihood from a likelihood.xml file or a bare type name.

    reference: src/likelihoods/LikelihoodFactory.cpp:31-101 and
    src/bcminf/main.cpp:43-50 (likelihood read from XML root
    <bcm_likelihood type=...>).
    """
    attrs: Dict[str, str] = {}
    if filename_or_type.endswith(".xml"):
        root = ET.parse(filename_or_type).getroot()
        if root.tag != "bcm_likelihood":
            raise ValueError(
                f"likelihood file root must be bcm_likelihood, got {root.tag}"
            )
        ltype = root.get("type")
        attrs = dict(root.attrib)
        attrs["_xml_path"] = filename_or_type
        attrs["_xml_root"] = root  # type: ignore[assignment]
    else:
        ltype = filename_or_type
        attrs = {
            k: (v if k.startswith("_") or not isinstance(v, (int, float)) else str(v))
            for k, v in kwargs.items()
        }

    if ltype not in _REGISTRY:
        raise ValueError(
            f"Unknown likelihood type '{ltype}'; available: {available_likelihoods()}"
        )
    return _REGISTRY[ltype](varset, attrs)


# ---------------------------------------------------------------------------
# Analytic test likelihoods


@register_likelihood("banana")
def _banana(varset: VariableSet, attrs) -> Likelihood:
    dim = int(attrs.get("dimension", varset.num_variables))
    if dim != varset.num_variables:
        raise ValueError("Banana dimension does not match prior variable count")
    sd1 = float(attrs["sd1"])
    sd2 = float(attrs["sd2"])
    if sd1 <= 0 or sd2 <= 0:
        raise ValueError("Standard deviations must be positive")
    return Likelihood("banana", analytic.make_banana(dim, sd1, sd2), attrs=attrs)


@register_likelihood("circular")
def _circular(varset: VariableSet, attrs) -> Likelihood:
    dim = int(attrs.get("dimension", varset.num_variables))
    if dim != varset.num_variables:
        raise ValueError("Circular dimension does not match prior variable count")
    radius = float(attrs.get("radius", 2.0))
    offset = float(attrs.get("offset", 3.5))
    # the reference example file contains width="=0.1"; boost's lexical cast
    # fails silently into the default there, so strip stray '=' prefixes
    width = float(str(attrs.get("width", 0.1)).lstrip("="))
    return Likelihood(
        "circular", analytic.make_circular(dim, radius, offset, width), attrs=attrs
    )


@register_likelihood("multimodal_gaussians")
def _multimodal(varset: VariableSet, attrs) -> Likelihood:
    if varset.num_variables != 2:
        raise ValueError("multimodal_gaussians requires exactly 2 variables")
    return Likelihood(
        "multimodal_gaussians", analytic.make_multimodal_gaussians(), attrs=attrs
    )


@register_likelihood("truncated_t")
def _truncated_t(varset: VariableSet, attrs) -> Likelihood:
    dim = int(attrs["dimensions"])
    if dim != varset.num_variables:
        raise ValueError("truncated_t dimensions do not match prior variable count")
    k = int(attrs["num_clusters"])
    mus = [parse_vector(attrs[f"mu{i+1}"]) for i in range(k)]
    sigmas = [parse_matrix(attrs[f"sigma{i+1}"]) for i in range(k)]
    nus = parse_vector(attrs["nus"])
    weights = parse_vector(attrs["weights"])
    if len(nus) != k or len(weights) != k:
        raise ValueError("Inconsistent number of nus/weights")
    return Likelihood(
        "truncated_t", analytic.make_truncated_t(mus, sigmas, nus, weights), attrs=attrs
    )


@register_likelihood("pharmaco_single")
def _pharmaco_single(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu.likelihoods.pharmaco import create_pharmaco_single

    model = create_pharmaco_single(varset, attrs)
    lik = Likelihood("pharmaco_single", model.log_prob, attrs=attrs)
    lik.model = model
    return lik


@register_likelihood("pharmaco_population")
def _pharmaco_population(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu.likelihoods.pharmaco import create_pharmaco_population

    model = create_pharmaco_population(varset, attrs)
    lik = Likelihood("pharmaco_population", model.log_prob, attrs=attrs)
    lik.model = model
    return lik


@register_likelihood("cell_population")
def _cell_population(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu.cellpop.likelihood import create_cellpop_likelihood

    model = create_cellpop_likelihood(varset, attrs)
    lik = Likelihood("cell_population", model.log_prob, attrs=attrs)
    lik.model = model
    return lik


@register_likelihood("cell_cycle_marker")
def _ccm(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu.likelihoods.cellmisc import create_cell_cycle_marker

    model = create_cell_cycle_marker(varset, attrs)
    return Likelihood("cell_cycle_marker", model.log_prob, attrs=attrs)


@register_likelihood("mitosis_time_estimation")
def _mte(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu.likelihoods.cellmisc import create_mitosis_time_estimation

    model = create_mitosis_time_estimation(varset, attrs)
    return Likelihood("mitosis_time_estimation", model.log_prob, attrs=attrs)


@register_likelihood("incucyte_population")
def _incucyte(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu.likelihoods.cellmisc import create_incucyte_population

    model = create_incucyte_population(varset, attrs)
    lik = Likelihood("incucyte_population", model.log_prob, attrs=attrs)
    lik.model = model
    return lik


@register_likelihood("fISA")
def _fisa(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu.fisa import create_fisa_likelihood

    model = create_fisa_likelihood(varset, attrs)
    lik = Likelihood("fISA", model.log_prob, attrs=attrs)
    lik.model = model
    return lik


@register_likelihood("dummy")
def _dummy(varset: VariableSet, attrs) -> Likelihood:
    return Likelihood("dummy", analytic.make_dummy(), attrs=attrs)


@register_likelihood("ODE")
def _ode_template(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu.likelihoods.ode_template import ODETemplateLikelihood

    model = ODETemplateLikelihood(varset, derivative=attrs.get("_derivative"))
    lik = Likelihood("ODE", model.log_prob, attrs=attrs)
    lik.model = model
    return lik


@register_likelihood("dll")
def _dll(varset: VariableSet, attrs) -> Likelihood:
    import os

    from bcm3_tpu.likelihoods.plugin import load_plugin_log_prob

    base = attrs.get("dll_filename_base") or attrs.get("plugin")
    if not base:
        raise ValueError("dll likelihood requires a dll_filename_base attribute")
    xml_path = attrs.get("_xml_path")
    base_dir = os.path.dirname(xml_path) if xml_path else "."
    log_prob = load_plugin_log_prob(base, list(varset.names), base_dir)
    return Likelihood("dll", log_prob, attrs=attrs)


@register_likelihood("pop_pk_trajectory")
def _pop_pk(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu.likelihoods.poppk import create_poppk_likelihood

    pk = create_poppk_likelihood(varset, attrs)
    lik = Likelihood("pop_pk_trajectory", pk.log_prob, attrs=attrs)
    lik.model = pk  # expose trajectories for predict/R-bridge equivalents
    lik.log_prob_batched = pk.log_prob_batched  # fused transit kernel
    return lik


@register_likelihood("pharmacokinetic_trajectory")
def _pk_single(varset: VariableSet, attrs) -> Likelihood:
    from bcm3_tpu.likelihoods.pk_single import create_pk_likelihood

    pk = create_pk_likelihood(varset, attrs)
    lik = Likelihood("pharmacokinetic_trajectory", pk.log_prob, attrs=attrs)
    lik.model = pk
    return lik
