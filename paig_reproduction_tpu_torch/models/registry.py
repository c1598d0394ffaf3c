"""Model registry: model name (the ``--model`` flag) -> model class."""
from __future__ import annotations

from paig_reproduction_tpu_torch.models.physics_net import PhysicsNet

MODELS = {
    "PhysicsNet": PhysicsNet,
}


def get_model(name: str):
    if name not in MODELS:
        raise KeyError(
            f"Unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name]
