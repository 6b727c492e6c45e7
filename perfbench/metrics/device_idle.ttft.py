"""Device idle share: ``readers.device_idle``."""
from perfbench.readers import device_idle as read  # noqa: F401
