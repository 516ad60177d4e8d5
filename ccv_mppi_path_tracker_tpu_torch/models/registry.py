"""Model registry keyed by the names used in SolverConfig.model."""

from __future__ import annotations

from ccv_mppi_path_tracker_tpu_torch.models.base import Model

_REGISTRY = {}


def register_model(model: Model) -> Model:
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> Model:
    # the built-in models register on import of the models package
    import ccv_mppi_path_tracker_tpu_torch.models  # noqa: F401

    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
