"""The harness on the card, at a small size: the kernels' path through the
window, the trace and the reference.  Skips without an NVIDIA card; on one,
run ``python3 -m pytest -m cuda portbench/tests/test_portbench_card.py``."""

import pytest
import torch

from portbench import run as R

from .test_portbench_run import check_schema, tiny_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels have no CPU mode")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_on_the_card(card, trace):
    result = R.run_cell(tiny_cell(), 11, 1.0, bool(trace), card)
    check_schema(result, trace)
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
        assert 0 < result["metrics"]["kernels_roofline.flush"]["value"] < 100
        assert 0 <= result["metrics"]["device_idle_pct.flush"]["value"] < 100
    else:
        assert result["metrics"]["ops_per_s"]["value"] > 0
