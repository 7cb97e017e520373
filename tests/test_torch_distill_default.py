"""The default model's 10-step ``make_distill_steps`` trajectory (ResNet one
block a stage at full widths and the pre-norm BERT encoder, 64 px) against
the JAX package's on the CPU, under the tests of tests/test_torch_distill.py,
which runs the flagship's: the losses, the step-0 gradients (the stem's and
layer1's ReLU-crossed leaves normwise), the histograms, and the parameters
and statistics after the first and the last step, the statistics held to
tests/test_torch_default_train.py's pin against the JAX step in float64.
A file of its own so that each file stays near a minute alone."""

import pytest
import torch

from test_torch_distill import (  # noqa: F401  (collected here as well)
    test_distill_histograms_are_the_jax_binning_at_the_pre_update_weights,
    test_distill_loss_trajectory_matches_jax,
    test_distill_parameters_and_statistics_match_jax,
    test_distill_step_0_gradients_match_jax,
    trajectory,
)

# tier-1 runs six test workers on eight cores: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run():
    return trajectory("default")
