from ilqr_tpu_torch.sim.scenario import ScenarioSetup, build_scenario_setup
from ilqr_tpu_torch.sim.mpc import run_mpc, run_mpc_scan

__all__ = ["ScenarioSetup", "build_scenario_setup", "run_mpc", "run_mpc_scan"]
