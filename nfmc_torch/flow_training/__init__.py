"""Flow training algorithms beyond plain MLE / reverse KL (counterpart of
``nfmc_tpu/flow_training``; reference L5)."""
from .fab import FAB, fab, flow_annealed_importance_sampling_bootstrap_base

__all__ = ["FAB", "fab", "flow_annealed_importance_sampling_bootstrap_base"]
