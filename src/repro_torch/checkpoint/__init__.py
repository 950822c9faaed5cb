from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager, save_pytree, load_pytree,
)
