"""PyTorch port of the constrained-iLQR framework, for one NVIDIA H100.

Counterpart of ``ilqr_tpu`` with the same module paths and public names.
Plain tensor code is PyTorch with an explicit leading scenario axis; the
fused whole-solve Pallas TPU kernel becomes a CUDA C++ kernel written for
Hopper (``ops/cuda/cilqr_kernel.py``, ``csrc/cilqr_kernel.cu``). This
package imports neither ``jax`` nor ``ilqr_tpu``.
"""

from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.solvers.cilqr import (
    CILQRCarry,
    CILQRConfig,
    CILQRSolver,
    CILQRWeights,
    SolveStatus,
    solve,
)

__all__ = [
    "GlobalConfig",
    "CILQRConfig",
    "CILQRWeights",
    "CILQRCarry",
    "CILQRSolver",
    "SolveStatus",
    "solve",
]

__version__ = "0.1.0"
