from ilqr_tpu_torch.solvers.cilqr import CILQRSolver, solve, solve_batch

__all__ = ["CILQRSolver", "solve", "solve_batch"]
