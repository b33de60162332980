"""Pretty JSON printing, as the JAX package's ``utils/json_utils.py``."""
import json
from typing import Any


def beautify_json(data: Any, indent: int = 4) -> str:
    return json.dumps(data, indent=indent, ensure_ascii=False, default=str)
