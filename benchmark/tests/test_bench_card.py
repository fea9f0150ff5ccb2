"""Each cell at a small size on the card, and the two-base cells: the
timed path on ``cuda`` is correct and takes the route its workload
names."""

import pytest

from benchmark import run
from conftest import CELLS, SMALL, TWO_BASE, spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS + tuple(TWO_BASE))
def test_cell_on_card(cuda_card, workload):
    from modkit_tpu_torch.ops import state

    q0, f0 = state.STATE_KERNEL_LAUNCHES, state.STATE_F32_KERNEL_LAUNCHES
    res = run.run_cell(workload, 7, 0.5, False, device="cuda", data_override=SMALL,
                       cell_spec=spec(workload) if workload in TWO_BASE else None)
    assert res["correct"] is True and res["device"]["kind"] == cuda_card
    f32 = workload.endswith("traditional")
    assert (state.STATE_F32_KERNEL_LAUNCHES > f0) == f32
    assert (state.STATE_KERNEL_LAUNCHES > q0) != f32
