from paig_reproduction_tpu_torch.models.physics_net import (  # noqa: F401
    PhysicsNet,
    compute_losses,
)
