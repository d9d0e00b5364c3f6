"""Communication config: one `CommConfig` for every inter-machine byte."""
from repro_torch.comm.config import CommConfig, PlaneConfig

__all__ = ["CommConfig", "PlaneConfig"]
