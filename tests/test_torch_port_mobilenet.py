"""The port's ``MobileNetV2`` trunk held against the JAX package's on the
CPU: the MobileNetV2 cases of ``tests/test_torch_port_pysot_trunks.py``
(``out_stages`` (3, 5, 7) at 255^2 and (7,) at 64^2, f32 and bf16,
``train`` False and True), with its helpers and tolerances, in a file of
their own so that the test runner's workers share the two trunks."""

import pytest

from test_torch_port_pysot_trunks import (
    MOBILENET,
    check_bf16,
    check_f32,
    check_round_trip,
)
from torch_port_fixtures import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_torch_thread()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", MOBILENET)
def test_trunk_f32_matches_jax(name, train):
    check_f32(name, train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", MOBILENET)
def test_trunk_bf16_matches_jax(name, train):
    check_bf16(name, train)


def test_flat_variables_round_trip():
    check_round_trip("mobilenet_7_64")
