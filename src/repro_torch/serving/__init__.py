from repro_torch.serving.engine import (  # noqa: F401
    Request, ServeConfig, ServingEngine, Slot)
