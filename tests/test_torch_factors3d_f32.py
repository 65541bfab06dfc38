"""The port's 3-D, polar and partial factor library against the JAX package
in float32: each factor type's whitened residuals and Jacobians within 2e-5
of the JAX package's ``vmap(jacfwd)`` on the same seeded float32 graph (the
float64 cases are in tests/test_torch_factors3d.py)."""

import pytest

pytest.importorskip("torch")
from test_torch_factors3d import CASES, check_linearization  # noqa: E402


@pytest.mark.parametrize("name", list(CASES))
def test_factor_linearization_matches_jax_f32(name):
    check_linearization(name, "float32")
