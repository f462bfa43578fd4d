from ilqr_tpu_torch.ops import constraints, cost, projection, riccati, dare

__all__ = ["constraints", "cost", "projection", "riccati", "dare"]
