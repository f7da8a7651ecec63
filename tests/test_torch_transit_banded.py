"""The port's banded TransitModel (bands=4) in transit geometry with the
atmosphere file's radii against transit_tpu's: compute, forward, the
gradient and forward_batch, with the checks and tolerances of
tests/test_torch_transit_model.py."""

import pytest
import torch

from tests.test_torch_transit_model import (
    check_compute, check_forward, check_forward_batch, check_gradient,
    make_pair)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair(False, 4)


def test_compute_matches_jax(pair):
    check_compute(pair)


def test_forward_matches_jax(pair):
    check_forward(pair)


def test_gradient_matches_jax(pair):
    check_gradient(pair)


def test_forward_batch_matches_jax(pair):
    check_forward_batch(pair)
