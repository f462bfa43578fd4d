"""Scenario construction: lane geometry + agent routing generation.

Counterpart of ``ilqr_tpu/sim/scenario.py``, a host-side mirror of the app
setup in reference src/motion_planning.cpp:91-174:

- border / center ``ReferenceLine``s from the config's lateral widths;
- ``road_borders = [max, min]`` of the border widths (:101-103);
- per-agent routing: snap the initial position to the nearest center line
  via the reference's walk (:126-141), then advance along s at constant
  speed each tick, direction deduced from the initial yaw (:144-158),
  with optional 50%-probability Gaussian position noise per tick
  (:163-171), seeded through ``numpy.random.default_rng``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ilqr_tpu_torch.config import GlobalConfig
from ilqr_tpu_torch.types import Scenario, numpy_dtype
from ilqr_tpu_torch.utils.refline import ReferenceLine, RoutingLine, stack_routing_lines


@dataclasses.dataclass
class ScenarioSetup:
    """Everything the MPC driver needs for one scenario."""

    gc: GlobalConfig
    borders: List[ReferenceLine]
    center_lines: List[ReferenceLine]
    road_borders: np.ndarray  # (2,) [max, min] border widths
    routing_lines: List[RoutingLine]  # index 0 = ego
    ego_x0: np.ndarray  # (4,)

    @property
    def obs_routing_lines(self) -> List[RoutingLine]:
        return self.routing_lines[1:]

    @property
    def num_obstacles(self) -> int:
        return len(self.routing_lines) - 1

    @property
    def num_ticks(self) -> int:
        return int(round(self.gc["max_simulation_time"] / self.gc["delta_t"]))

    def obs_preds_array(self, dtype=np.float64) -> np.ndarray:
        """(M, T, 3) stacked obstacle routing lines."""
        return stack_routing_lines(self.obs_routing_lines, dtype=dtype)

    def device_scenario(self, tick: int = 0, horizon: Optional[int] = None,
                        dtype=torch.float64, device="cpu", batch: int = 1) -> Scenario:
        """Batched ``Scenario`` (``batch`` copies, as expanded views) with the
        obstacle window starting at ``tick``."""
        N = horizon if horizon is not None else int(self.gc["lqr/N"])
        npd = numpy_dtype(dtype)
        obs = self.obs_preds_array(npd)
        window = obs[:, tick: tick + N + 1, :] if obs.size else np.zeros((0, N + 1, 3), npd)

        def t(a):
            a = torch.as_tensor(np.asarray(a, npd), device=device)
            return a.expand((batch,) + tuple(a.shape))

        return Scenario(
            ref_line=t(self.center_lines[0].as_array(dtype=npd)),
            ref_velo=t(self.gc["vehicle/target_velocity"]),
            obs_preds=t(window),
            road_borders=t(self.road_borders),
        )


def _snap_to_center_line(center_lines: Sequence[ReferenceLine], x0: float,
                         y0: float):
    """Nearest-center-line walk (reference src/motion_planning.cpp:126-141):
    walk each line until the distance stops decreasing; the first local
    minimum is that line's candidate."""
    line_num = 0
    start_s = center_lines[0].length
    min_diff = -1.0
    for idx, line in enumerate(center_lines):
        for i in range(1, line.size):
            last_diff = math.hypot(line.x[i - 1] - x0, line.y[i - 1] - y0)
            cur_diff = math.hypot(line.x[i] - x0, line.y[i] - y0)
            if cur_diff > last_diff:
                if min_diff < 0 or last_diff < min_diff:
                    min_diff = last_diff
                    line_num = idx
                    start_s = line.longitude[i - 1]
                break
    return line_num, start_s


def _truncated_normal(rng, mean: float, std: float) -> float:
    """Resample-beyond-3-sigma truncated normal (reference src/utils.cpp:76-84)."""
    while True:
        v = rng.normal(mean, std)
        if -3 * std <= v <= 3 * std:
            return v


def generate_routing_lines(gc: GlobalConfig, center_lines: Sequence[ReferenceLine],
                           noise: bool = False, seed: int = 0) -> List[RoutingLine]:
    """Per-vehicle routing lines over max_simulation_time + 10 seconds
    (reference src/motion_planning.cpp:121-174)."""
    delta_t = gc["delta_t"]
    max_sim_time = gc["max_simulation_time"]
    rng = np.random.default_rng(seed)
    lines: List[RoutingLine] = []
    for idx, cond in enumerate(gc["initial_condition"]):
        x0, y0, v0, yaw0 = (float(c) for c in cond[:4])
        line_num, start_s = _snap_to_center_line(center_lines, x0, y0)
        line = center_lines[line_num]
        routing = RoutingLine()
        t = 0.0
        while t < max_sim_time + 10:
            # direction deduced from the initial yaw (reference
            # src/motion_planning.cpp:147-158)
            if yaw0 <= math.pi / 2:
                cur_s = min(start_s + t * v0, line.longitude[-1])
                pos = line.calc_position(cur_s)
                yaw = float(pos[2])
            else:
                cur_s = max(start_s - t * v0, line.longitude[0])
                pos = line.calc_position(cur_s)
                yaw = math.fmod(float(pos[2]) + math.pi, 2 * math.pi)
            px, py = float(pos[0]), float(pos[1])
            if noise and idx != 0 and rng.uniform() >= 0.5:
                px += _truncated_normal(rng, 0.0, 0.02)
                py += _truncated_normal(rng, 0.0, 0.02)
            routing.x.append(px)
            routing.y.append(py)
            routing.yaw.append(yaw)
            t += delta_t
        lines.append(routing)
    return lines


def build_scenario_setup(gc: GlobalConfig, noise: bool = False,
                         seed: int = 0) -> ScenarioSetup:
    ref_x = [float(v) for v in gc["laneline/reference/x"]]
    ref_y = [float(v) for v in gc["laneline/reference/y"]]
    border_widths = [float(v) for v in gc["laneline/border"]]
    center_widths = [float(v) for v in gc["laneline/center_line"]]
    center_lines = [ReferenceLine(ref_x, ref_y, w) for w in center_widths]
    return ScenarioSetup(
        gc=gc,
        borders=[ReferenceLine(ref_x, ref_y, w) for w in border_widths],
        center_lines=center_lines,
        road_borders=np.array([max(border_widths), min(border_widths)]),
        routing_lines=generate_routing_lines(gc, center_lines, noise=noise, seed=seed),
        ego_x0=np.asarray([float(v) for v in gc["initial_condition"][0][:4]]),
    )


def perturbed_initial_states(x0: np.ndarray, n: int, seed: int = 0,
                             scales=(0.5, 0.2, 0.5, 0.02)) -> np.ndarray:
    """(n, 4) batch of perturbed ego initial states (numpy; bit-identical to
    ``ilqr_tpu.sim.scenario.perturbed_initial_states``)."""
    rng = np.random.default_rng(seed)
    return x0[None, :] + rng.normal(size=(n, 4)) * np.asarray(scales)
