"""JSON config load/save: the port's copy of
``gymfx_tpu/config/handler.py`` (:16-42).

``compose_config`` persists only keys that differ from the repo defaults
(reference app/config_handler.py:11-17 semantics).  The reference's
vestigial remote HTTP load/save (app/config_handler.py:30-73) is
intentionally not reproduced; remote config belongs to the orchestration
layer, not the env package.
"""
import json
from pathlib import Path
from typing import Any, Dict

from gymfx_tpu_torch.config.defaults import DEFAULT_VALUES


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as fh:
        config = json.load(fh)
    if not isinstance(config, dict):
        raise ValueError("config file must contain a JSON object")
    return config


def compose_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only non-default, JSON-serializable keys."""
    composed: Dict[str, Any] = {}
    for key, value in config.items():
        if key in DEFAULT_VALUES and DEFAULT_VALUES[key] == value:
            continue
        try:
            json.dumps(value)
        except (TypeError, ValueError):
            continue
        composed[key] = value
    return composed


def save_config(config: Dict[str, Any], path: str) -> None:
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", encoding="utf-8") as fh:
        json.dump(compose_config(config), fh, indent=2)
