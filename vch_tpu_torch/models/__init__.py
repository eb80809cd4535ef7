"""Forward and adjoint solvers of the port, under vch_tpu.models's names
(vch_tpu/models/__init__.py): the 1D solvers at import, the 2D ones on
first access."""
from vch_tpu_torch.models.adjoint1d import AdjointSolver1D
from vch_tpu_torch.models.forward1d import ForwardSolver1D

__all__ = ["ForwardSolver1D", "AdjointSolver1D"]


def __getattr__(name):
    if name == "ForwardSolver2D":
        from vch_tpu_torch.models.forward2d import ForwardSolver2D
        return ForwardSolver2D
    if name == "AdjointSolver2D":
        from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
        return AdjointSolver2D
    raise AttributeError(name)
