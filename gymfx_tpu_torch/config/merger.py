"""Layered config merge with fixed precedence: the port's copy of
``gymfx_tpu/config/merger.py`` (:11-77).

Precedence (low -> high), matching the reference merge semantics
(reference app/config_merger.py:37-51):
    plugin defaults < repo defaults < config file < explicit CLI args
    (non-None) < unknown ``--key value`` args with type coercion.
"""
from typing import Any, Dict, Iterable, Mapping, Optional


def process_unknown_args(unknown_args: Iterable[str]) -> Dict[str, Any]:
    """Turn leftover ``--key value`` / ``--flag`` CLI tokens into a dict.

    A ``--key`` immediately followed by a non-flag token takes that
    token as its value; a ``--key`` followed by another flag (or by
    nothing) is a boolean switch.  Stray positional tokens with no
    preceding flag are ignored (the JAX package's semantics,
    tests/test_torch_cli.py).
    """
    parsed: Dict[str, Any] = {}
    pending: Optional[str] = None  # flag still waiting for its value
    for token in unknown_args:
        if token.startswith("--"):
            if pending is not None:
                parsed[pending] = True
            pending = token.lstrip("-")
        elif pending is not None:
            parsed[pending] = token
            pending = None
    if pending is not None:
        parsed[pending] = True
    return parsed


_LITERAL_VALUES: Dict[str, Any] = {
    "true": True,
    "false": False,
    "none": None,
    "null": None,
}


def convert_type(value: Any) -> Any:
    """Coerce CLI string values: literal bool/None, else the narrowest
    of int -> float -> str.  Non-strings pass through untouched."""
    if not isinstance(value, str):
        return value
    lowered = value.strip().lower()
    if lowered in _LITERAL_VALUES:
        return _LITERAL_VALUES[lowered]
    for parse in (int, float):
        try:
            return parse(value)
        except ValueError:
            continue
    return value


def merge_config(
    defaults: Optional[Mapping[str, Any]],
    plugin_params1: Optional[Mapping[str, Any]] = None,
    plugin_params2: Optional[Mapping[str, Any]] = None,
    file_config: Optional[Mapping[str, Any]] = None,
    cli_args: Optional[Mapping[str, Any]] = None,
    unknown_args: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    merged: Dict[str, Any] = {}
    merged.update(plugin_params1 or {})
    merged.update(plugin_params2 or {})
    merged.update(defaults or {})
    merged.update(file_config or {})
    for key, value in (cli_args or {}).items():
        if value is not None:
            merged[key] = value
    for key, value in (unknown_args or {}).items():
        merged[key] = convert_type(value)
    return merged
