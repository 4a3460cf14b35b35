"""JSON configuration with typed parameters and defaults.

Mirrors the reference's ``Configuration`` / ``Parameter<T>`` system
(reference: src/sietill/Config.{hpp,cpp}) — a flat JSON object queried by
typed parameter objects that fall back to a default when the key is absent.
Sub-configs and arrays are supported for the NN layer definitions.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Generic, List, TypeVar

T = TypeVar("T")


class Configuration:
    """A (possibly nested) view into a parsed JSON config.

    Reference: src/sietill/Config.cpp:38-95.
    """

    def __init__(self, source: Any = None):
        if source is None:
            self._data = {}
        elif isinstance(source, dict):
            self._data = source
        elif isinstance(source, str):
            with open(source, "r") as f:
                self._data = json.load(f)
            if not isinstance(self._data, dict):
                raise ValueError("Top level configuration is not an object")
        else:
            raise TypeError(f"cannot build Configuration from {type(source)}")

    def has_value(self, name: str) -> bool:
        return name in self._data

    def get_value(self, name: str) -> Any:
        return self._data[name]

    def is_array(self, name: str) -> bool:
        return name in self._data and isinstance(self._data[name], list)

    def get_array(self, name: str) -> List["Configuration"]:
        return [Configuration(v) for v in self._data[name]]

    def get_string_array(self, name: str) -> List[str]:
        return [str(v) for v in self._data[name]]

    def sub_config(self, name: str) -> "Configuration":
        return Configuration(self._data[name])

    def updated(self, **overrides: Any) -> "Configuration":
        """Functional override — convenient for sweeps and tests."""
        d = dict(self._data)
        d.update(overrides)
        return Configuration(d)

    def as_dict(self) -> dict:
        return dict(self._data)


@dataclass(frozen=True)
class Parameter(Generic[T]):
    """Typed parameter with default (reference: Config.cpp:105-126)."""

    name: str
    default: T
    type_: type = object

    def __call__(self, config: Configuration) -> T:
        if config.has_value(self.name):
            v = config.get_value(self.name)
            if self.type_ is not object:
                if self.type_ is float and isinstance(v, int):
                    v = float(v)
                if self.type_ is bool and not isinstance(v, bool):
                    raise TypeError(f"{self.name} has invalid type")
                if not isinstance(v, self.type_):
                    raise TypeError(f"{self.name} has invalid type")
            return v
        return self.default


def ParameterBool(name: str, default: bool) -> Parameter:
    return Parameter(name, default, bool)


def ParameterInt(name: str, default: int) -> Parameter:
    return Parameter(name, default, int)


ParameterUInt = ParameterInt
ParameterInt64 = ParameterInt
ParameterUInt64 = ParameterInt


def ParameterFloat(name: str, default: float) -> Parameter:
    return Parameter(name, float(default), float)


ParameterDouble = ParameterFloat


def ParameterString(name: str, default: str) -> Parameter:
    return Parameter(name, default, str)
