"""Example model files written from code.

The banana example is the 2-D twisted-Gaussian target of the upstream
examples/banana directory, with the prior box of the C++ engine anchor
(tools/baseline_banana.cpp:51-52), so runs on it compare against that
engine's records in baseline_cpu.json (``banana_acceptance``,
``banana_engine_cpp``).
"""

from __future__ import annotations

import os

# uniform prior bounds (lower, upper) of x1 and x2
BANANA_PRIOR_BOX = ((-6.0, 4.0), (-6.0, 20.0))
BANANA_SD = (2.0, 1.0)


def write_banana_example(directory: str) -> tuple[str, str]:
    """Write prior.xml and likelihood.xml of the banana example into
    ``directory``; returns their paths."""
    os.makedirs(directory, exist_ok=True)
    prior_xml = os.path.join(directory, "prior.xml")
    lik_xml = os.path.join(directory, "likelihood.xml")
    (lo1, hi1), (lo2, hi2) = BANANA_PRIOR_BOX
    with open(prior_xml, "w") as f:
        f.write(
            "<prior>\n"
            f'  <variable name="x1" distribution="uniform" lower="{lo1:g}"'
            f' upper="{hi1:g}"/>\n'
            f'  <variable name="x2" distribution="uniform" lower="{lo2:g}"'
            f' upper="{hi2:g}"/>\n'
            "</prior>\n"
        )
    with open(lik_xml, "w") as f:
        f.write(
            f'<bcm_likelihood type="banana" sd1="{BANANA_SD[0]:g}"'
            f' sd2="{BANANA_SD[1]:g}"/>\n'
        )
    return prior_xml, lik_xml
