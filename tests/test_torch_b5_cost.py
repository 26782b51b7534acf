"""The B5 cost script (``hnanosolver_tpu_torch/tools/b5_cost.py``) on the
CPU: it measures barriers that have no plain version, so it runs on the card
only and refuses the CPU; its inputs are the bench plume's multigrid levels
that B5 solves on the main paths and, for the threshold sweep, capacities
built from level 1's tiles.
"""

import pytest
import torch

from hnanosolver_tpu_torch.ops import cuda_pressure as tcp
from hnanosolver_tpu_torch.tools import b5_cost

torch.set_num_threads(1)


def test_b5_cost_refuses_the_cpu():
    with pytest.raises(SystemExit, match="the card only"):
        b5_cost.main(["--device", "cpu"])


def test_b5_cost_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b5_cost.main([])


def test_levels_are_the_main_path_levels():
    lv = b5_cost.levels(torch.device("cpu"))
    assert [T for T, *_ in lv] == [1024, 128, 32]
    for T, nbr, div, mask, dx2 in lv:
        assert nbr.shape == (T, 27) and div.shape == mask.shape == (T, 512)
        assert not div[mask == 0].any() and mask.sum() > 0
    assert [dx2 for *_, dx2 in lv] == [1.0, 4.0, 16.0]  # (0.5 * 2^k)^2


@pytest.mark.parametrize("T", [b5_cost.SWEEP[0], tcp.CLUSTER_ROWS, b5_cost.SWEEP[-1]])
def test_sweep_levels_hold_both_forms(T):
    nbr, div, mask, dx2 = b5_cost.sweep_level(torch.device("cpu"), T)
    assert nbr.shape == (T, 27) and div.shape == (T, 512) and dx2 == 1.0
    assert tcp.fused_shape(T, "cluster").form == "cluster"  # both forms hold every swept T
    assert tcp.fused_shape(T, "grid").form == "grid"
    assert int(mask[:, 0].sum()) == min(T - 1, 639)  # level 1's tiles, at most T - 1
