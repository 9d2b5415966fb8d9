"""The check that decides `correct`: the program passes it, the control
(the reference in bfloat16 in the program's place) fails it, and so does
a run with a fault planted under the timed path.  On the CPU at the small
sizes of small.py; on the card at each cell's own size (marked cuda)."""

import time

import pytest
import torch

import control
import faults
from pbench import check, result
from pbench.cell import Cell
from small import small_cell

CELLS = ("replica_office0.gt_stream", "replica_room0_slam.unposed_stream",
         "replica_office0.recon_stream")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12, 13])
@pytest.mark.parametrize("workload", CELLS)
def test_the_program_passes_and_the_control_fails(workload, seed):
    prog, low = control.readings(small_cell(workload), seed, 0.3, True, "cpu")
    assert prog["fails"] == [], prog
    assert low["fails"], low


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS[:2])
def test_a_fault_under_the_timed_path_makes_the_run_not_correct(workload, fault, monkeypatch):
    class FaultyRun(result.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            faults.plant(self, {fault}, monkeypatch.setattr)

    monkeypatch.setattr(result, "Run", FaultyRun)
    out, lines = result.run_cell(small_cell(workload), 21, 0.3, False, "cpu",
                                 time.perf_counter())
    assert out["correct"] is False, lines
    assert list(out)[-1] == "checks"


def test_the_limits_name_every_number_the_check_compares():
    assert set(check.LIMITS) == {"track_gap_voxels", "fusion_sdf_gap_mu", "fusion_weights_apart",
                                 "fusion_color_gap", "raycast_hits_apart", "raycast_gap_voxels",
                                 "window_loss_gap", "window_change_gap", "window_rows_apart",
                                 "render_weight_gap", "render_color_gap"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_own_size(card, workload):
    prog, low = control.readings(Cell(workload), 7, 2.0, True, card)
    assert prog["fails"] == [], prog
    assert low["fails"], low


def test_a_row_pruned_on_one_side_only_shifts_no_other_row():
    """The window's rows are matched by their means near their place, so
    a prune decided otherwise on one row leaves the others compared."""
    g = torch.Generator().manual_seed(3)
    m = 64
    start = {"means": torch.rand((m, 3), generator=g) * 4, "scales": torch.rand((m, 3), generator=g),
             "quats": torch.rand((m, 4), generator=g), "features_dc": torch.rand((m, 3), generator=g),
             "features_rest": torch.rand((m, 15, 3), generator=g),
             "opacities": torch.rand((m, 1), generator=g)}
    pool = {k: v + 1e-3 * torch.randn(v.shape, generator=g) for k, v in start.items()}
    ref = {"pool": pool, "start": start, "losses": [0.5, 0.4], "spawned": 0,
           "new": torch.zeros(m, dtype=torch.bool),
           "grad0": {k: 1.0 for k in start}}
    other = {k: torch.cat([v[:5], v[6:]]) for k, v in pool.items()}
    got = check.window_numbers(ref, other, [0.5, 0.4])
    assert got["window_rows_apart"] == pytest.approx(1 / m)
    assert got["window_change_gap"] < 0.05 and got["window_loss_gap"] == 0.0
    longer = {k: torch.cat([v, v[-12:] + 1.0]) for k, v in pool.items()}
    assert check.window_numbers(ref, longer, [0.5, 0.4])["window_rows_apart"] == \
        pytest.approx(12 / m)
    stale = {k: torch.cat([v[:5], v[6:]]) for k, v in start.items()}
    assert check.window_numbers(ref, stale, [0.5, 0.4])["window_change_gap"] > 0.9
