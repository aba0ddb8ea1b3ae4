from gtsam_points_tpu_torch.optim.graph import FactorGraph, retract
from gtsam_points_tpu_torch.optim.lm import LMParams, LMResult, LMStatus, optimize_lm

__all__ = ["FactorGraph", "retract", "LMParams", "LMResult", "LMStatus", "optimize_lm"]
