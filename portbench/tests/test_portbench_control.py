"""The control, the reference computed in bfloat16 in the program's place,
fails each cell's limits: on the CPU at a small size, and on the card at
the cells' own sizes (``-m card -s`` prints the readings)."""

import pytest

from conftest import small_cell
from portbench.lib import checks, control, manifest

VIEWS = ["galaxy-bh-view", "plummer-quad-view"]


def _numbers(cell, seed, device):
    if cell.driver == "engine_view":
        return control.view_numbers(cell, seed, device)
    return control.grad_numbers(cell, seed, device)


@pytest.mark.parametrize("name", VIEWS + ["galaxy-bh-grad"])
def test_control_fails_at_a_small_size(name):
    cell = small_cell(name)
    ok, compared = checks.judge(_numbers(cell, 11, "cpu"),
                                cell.check["limits"])
    assert not ok, compared


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 7, 424242, 9001])
@pytest.mark.parametrize("name", VIEWS + ["galaxy-bh-grad"])
def test_control_fails_at_the_cells_size(card, name, seed):
    cell = manifest.load_cell(name)
    numbers = _numbers(cell, seed, card)
    ok, compared = checks.judge(numbers, cell.check["limits"])
    print(f"control {name} seed {seed}: {compared}")
    assert not ok, compared
