"""The differentiable side: refinement through the rollout, system
identification, the learned sampler and the learned update rule."""

from ccv_mppi_path_tracker_tpu_torch.diff.gradients import (
    gauss_newton_refine,
    gradient_refine,
    make_trajectory_cost,
    make_trajectory_residuals,
)
from ccv_mppi_path_tracker_tpu_torch.diff.learned_optimizer import (
    UpdateRule,
    evaluate_rule,
    learned_update_step,
    learned_weights,
    meta_train,
)
from ccv_mppi_path_tracker_tpu_torch.diff.learned_sampler import (
    SamplerNet,
    collect_imitation_data,
    fit_sampler,
    proposal_mean,
)
from ccv_mppi_path_tracker_tpu_torch.diff.system_id import (
    ControlGains,
    fit_control_gains,
    fit_full_body_params,
    rollout_prediction_loss,
    rollout_prediction_value_and_grad,
)

__all__ = [
    "UpdateRule",
    "evaluate_rule",
    "learned_update_step",
    "learned_weights",
    "meta_train",
    "make_trajectory_cost",
    "make_trajectory_residuals",
    "gradient_refine",
    "gauss_newton_refine",
    "SamplerNet",
    "collect_imitation_data",
    "fit_sampler",
    "proposal_mean",
    "ControlGains",
    "fit_control_gains",
    "fit_full_body_params",
    "rollout_prediction_loss",
    "rollout_prediction_value_and_grad",
]
