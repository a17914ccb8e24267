"""Lowering parity for the MobileNets (depthwise and channel-expanding
grouped layers, linear-bottleneck residuals): the port's plans, kernel
programs and operand tables equal the JAX package's at both budgets and
batches 1, 3 and 8. The checks are defined in test_torch_schedule.py."""
import pytest

pytest.importorskip("torch")

from test_torch_schedule import (check_graph_and_plans,  # noqa: E402
                            check_kernel_programs)

NAMES = ["mobilenet_v1", "mobilenet_v2"]


@pytest.mark.parametrize("name", NAMES)
def test_graphs_and_plans_match(name):
    check_graph_and_plans(name)


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("budget", ["default", None])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_programs_and_tables_match(name, budget, batch):
    check_kernel_programs(name, budget, batch)
