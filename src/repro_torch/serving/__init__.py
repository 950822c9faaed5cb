from repro_torch.serving.disagg import (  # noqa: F401
    DisaggServeConfig, DisaggServingEngine)
from repro_torch.serving.engine import (  # noqa: F401
    Request, ServeConfig, ServingEngine, Slot)
from repro_torch.serving.errors import (  # noqa: F401
    AdmissionError, DeadlineExceeded, EngineCrash, KernelFault, Outcome,
    PagePoolExhausted, ServingError, TransferFault)
