"""Operators, potentials and the CUDA-kernel wrappers of the port.

The public ops of vch_tpu/ops/__init__.py under the same names, on tensors
(the grids, Laplacian tables and stability analysis are host numpy, as in
vch_tpu). The kernel wrappers (`ops.march`, `ops.solve_kernels`,
`ops.probe_kernels`) are imported by name.
"""
from vch_tpu_torch.ops.grids import grid_1d, grid_2d, trapz_weights
from vch_tpu_torch.ops.laplacian import (
    apply_laplacian_1d,
    apply_laplacian_2d,
    laplacian_matrix_neumann,
    neumann_eigendecomposition,
    stencil_laplacian_1d,
    stencil_laplacian_2d,
)
from vch_tpu_torch.ops.linsolve import spectral_poly_solve
from vch_tpu_torch.ops.potential import (
    f_prime,
    fpp_log,
    free_energy_1d,
    free_energy_2d,
    init_phi_random_1d,
    init_phi_random_2d,
    regularized_log,
)
from vch_tpu_torch.ops.stability import dispersion_relation, instability_report

__all__ = [
    "trapz_weights", "grid_1d", "grid_2d",
    "laplacian_matrix_neumann", "neumann_eigendecomposition",
    "apply_laplacian_1d", "apply_laplacian_2d",
    "stencil_laplacian_1d", "stencil_laplacian_2d",
    "spectral_poly_solve",
    "regularized_log", "f_prime", "fpp_log",
    "free_energy_1d", "free_energy_2d",
    "init_phi_random_1d", "init_phi_random_2d",
    "dispersion_relation", "instability_report",
]
