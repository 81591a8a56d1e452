from repro_torch.obs.metrics import MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import Clock, Tracer, WallClock  # noqa: F401
