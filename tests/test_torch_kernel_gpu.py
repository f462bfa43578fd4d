"""The CUDA kernel against its plain PyTorch version, on the card.

Marked ``gpu``; skips without a CUDA device (the kernel has no CPU mode).
Imports only the port, so it runs on a GPU machine without the JAX package's
dependencies:  python -m pytest -m gpu tests/test_torch_kernel_gpu.py -q
"""

import os

import pytest
import torch

from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.ops.cuda import cilqr_kernel as ck
from ilqr_tpu_torch.sim.scenario import build_scenario_setup, perturbed_initial_states
from ilqr_tpu_torch.types import CILQRConfig, CILQRWeights

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "scenario_two_straight.yaml")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu(cuda_device):
    """Double kernel vs double plain version on the main path's window:
    iterations and statuses equal on >= 99% of rows (a threshold decision
    can flip on 1e-16 sum-order differences), u and x within 1e-6 on those
    rows; one launch counted."""
    gc = GlobalConfig.from_file(CONFIG)
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc)
    w = CILQRWeights.from_global_config(gc, dtype=torch.float64, device=cuda_device)
    B = 200  # two blocks of 128 threads, the second ragged
    x0 = torch.as_tensor(perturbed_initial_states(st.ego_x0, B, seed=0), device=cuda_device)
    sc = st.device_scenario(tick=0, dtype=torch.float64, device=cuda_device, batch=B)
    p = ck.pack_problem(cfg, x0, sc, 384, None, 24, ck.derive_proj_rows(8, 0.1))
    launches = ck.launches
    uk, xk, sk = ck.cilqr_solve_kernel(cfg, w, p)
    torch.cuda.synchronize()
    assert ck.launches == launches + 1
    ur, xr, sr = ck.cilqr_solve_ref(cfg, w, p)
    same = (sk[0] == sr[0]) & (sk[1] == sr[1])
    assert int(same.sum()) >= 0.99 * B
    assert float((uk - ur).abs()[:, :, same].max()) <= 1e-6
    assert float((xk - xr).abs()[:, :, same].max()) <= 1e-6
