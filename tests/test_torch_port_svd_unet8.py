"""``test_torch_port_svd_unet.py``'s tests of the tiny SVD UNet against
the JAX package at 8 input channels (no motion mask): the same inputs,
configurations and tolerance, in a file of its own so that the two halves
run side by side. The port's ``"packed"`` forward is held against JAX's
``"xla"`` output, which off the TPU is JAX's ``"packed"`` graph (held bit
for bit in the 9-channel file).
"""

import pytest

from test_torch_port_helpers import one_thread  # noqa: F401 (autouse fixture)
from test_torch_port_svd_unet import (case_for, jax_outputs,
                                      test_timestep_is_continuous_and_the_ids_are_fp32,
                                      test_tiny_svd_unet_matches_jax)

__all__ = ["jax_outputs", "test_timestep_is_continuous_and_the_ids_are_fp32",
           "test_tiny_svd_unet_matches_jax"]


@pytest.fixture(scope="module")
def case():
    return case_for(8)


@pytest.fixture(scope="module")
def jax_graph():
    return {"xla": "xla", "pallas": "pallas", "packed": "xla"}
