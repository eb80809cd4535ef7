"""Cost, prox and targets of the port, under vch_tpu.control's names
(vch_tpu/control/__init__.py)."""
from vch_tpu_torch.control.cost import (calculate_cost_1d, calculate_cost_2d,
                                        cost_breakdown_1d, cost_breakdown_2d)
from vch_tpu_torch.control.prox import (calculate_gradient,
                                        perform_gradient_step, proximal_step)
from vch_tpu_torch.control.targets import build_targets_1d, build_targets_2d

__all__ = [
    "calculate_cost_1d", "calculate_cost_2d",
    "cost_breakdown_1d", "cost_breakdown_2d",
    "calculate_gradient", "perform_gradient_step", "proximal_step",
    "build_targets_1d", "build_targets_2d",
]
