"""``AmodalPipeline.create(int8_backbone=True, dtype=torch.bfloat16)`` of
the port held against the JAX package's on the CPU, ``streaming`` and
``batched``, at every stem: the runs and the rule of
``tests/test_torch_port_int8_pipeline.py`` (a file of its own, so that
the two halves run in parallel)."""

import pytest

from test_torch_port_int8_pipeline import (
    STEMS,
    check_batched,
    check_streaming,
    make_runs,
)
from torch_port_fixtures import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


@pytest.fixture(scope="module", params=STEMS)
def runs(request, tmp_path_factory):
    return make_runs(request.param, "bf16", tmp_path_factory)


def test_int8_bf16_streaming_matches_jax(runs):
    check_streaming(runs)


def test_int8_bf16_batched_matches_jax_batched(runs):
    check_batched(runs)
