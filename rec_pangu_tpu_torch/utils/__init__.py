from .device import get_device_usage, resolve_device
from .json_utils import beautify_json
from .seed import seed_everything

__all__ = ["get_device_usage", "resolve_device", "beautify_json", "seed_everything"]
