from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig, adamw_init, adamw_update, lr_schedule,
)
