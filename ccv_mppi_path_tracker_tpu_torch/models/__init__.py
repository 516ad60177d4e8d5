"""Dynamics models; importing the package registers the built-in ones."""

from ccv_mppi_path_tracker_tpu_torch.models import (  # noqa: F401
    autorally_nn,
    full_body,
    pets_pe,
    rate_limited_steering,
    steering_unicycle,
    unicycle,
)
from ccv_mppi_path_tracker_tpu_torch.models.base import Model
from ccv_mppi_path_tracker_tpu_torch.models.registry import get_model, register_model

__all__ = ["Model", "get_model", "register_model"]
