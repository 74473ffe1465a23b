"""The banana example written from code (bcm3_tpu/example_files.py)."""

import numpy as np

from bcm3_tpu.example_files import BANANA_PRIOR_BOX, write_banana_example
from bcm3_tpu.likelihoods import create_likelihood
from bcm3_tpu.model.prior import Prior
from bcm3_tpu.model.variables import VariableSet


def test_banana_example_parses(tmp_path):
    prior_xml, lik_xml = write_banana_example(str(tmp_path / "banana"))
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    lik = create_likelihood(lik_xml, varset)
    assert varset.names == ["x1", "x2"]
    (lo1, hi1), (lo2, hi2) = BANANA_PRIOR_BOX
    area = (hi1 - lo1) * (hi2 - lo2)
    inside = np.array([[0.0, 1.0]])
    outside = np.array([[hi1 + 0.1, 1.0]])
    np.testing.assert_allclose(prior.log_pdf(inside), -np.log(area))
    assert np.isneginf(prior.log_pdf(outside)).all()
    # on the ridge x2 = 4 x1 + (1 - x1)^2 at x1 = 0: both normal terms peak
    expected = -np.log(2.0) - np.log(1.0) - np.log(2 * np.pi)
    np.testing.assert_allclose(lik.log_prob(np.array([0.0, 1.0])), expected)
