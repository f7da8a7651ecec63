"""The port's banded TransitModel (bands=4) in transit geometry with
hydrostatic radii (gsurf 980, refpress 1, refradius 92000) against
transit_tpu's: compute (the file's radii), forward, the gradient and
forward_batch (every member's radii, path weights and modulation table),
with the checks and tolerances of tests/test_torch_transit_model.py."""

import pytest
import torch

from tests.test_torch_transit_model import (
    check_compute, check_forward, check_forward_batch, check_gradient,
    make_pair)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair(True, 4)


def test_compute_matches_jax(pair):
    check_compute(pair)


def test_forward_matches_jax(pair):
    check_forward(pair)


def test_gradient_matches_jax(pair):
    check_gradient(pair)


def test_forward_batch_matches_jax(pair):
    check_forward_batch(pair)
