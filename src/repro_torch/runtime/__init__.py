from repro_torch.runtime.fault import FaultToleranceManager, HeartbeatMonitor  # noqa: F401
from repro_torch.runtime.elastic import ElasticState, replan_mesh  # noqa: F401
from repro_torch.runtime.chaos import ChaosConfig, ChaosEngine, parse_spec  # noqa: F401
