from .device_tables import DeviceTables  # noqa: F401
from .kernels import score_chunks  # noqa: F401
