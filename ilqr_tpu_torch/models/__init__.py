from ilqr_tpu_torch.models.bicycle import (
    GRAVITY_CENTER,
    REAR_CENTER,
    kinematic_propagate,
    kinematic_jacobians,
    rollout,
    const_velo_prediction,
    front_rear_centers,
    front_rear_center_jacobians,
)

__all__ = [
    "GRAVITY_CENTER",
    "REAR_CENTER",
    "kinematic_propagate",
    "kinematic_jacobians",
    "rollout",
    "const_velo_prediction",
    "front_rear_centers",
    "front_rear_center_jacobians",
]
