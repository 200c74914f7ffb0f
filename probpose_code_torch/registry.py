"""Component registry for the PyTorch port.

The port's own copy of ``probpose_code_tpu/registry.py``: components register
under a string name and are built from config dicts whose ``type`` key
selects the class, so the port reads the same config files as the JAX
package.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class/callable registry with config-dict build support."""

    def __init__(self, name: str):
        self.name = name
        self._module_dict: Dict[str, Callable] = {}

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self.name}, items={sorted(self._module_dict)})"

    def keys(self):
        return self._module_dict.keys()

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None, force: bool = False):
        """Register a class or callable. Usable as decorator or direct call."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module: Callable, name: Optional[str], force: bool):
        key = name or module.__name__
        if not force and key in self._module_dict and self._module_dict[key] is not module:
            raise KeyError(f"{key} is already registered in {self.name}")
        self._module_dict[key] = module

    def build(self, cfg: Any, **default_kwargs) -> Any:
        """Build an instance from a config dict with a ``type`` key.

        ``type`` may also be a class/callable directly. Remaining keys are
        passed as kwargs. Already-constructed objects pass through when they
        are not dicts.
        """
        if cfg is None:
            return None
        if not isinstance(cfg, dict):
            return cfg  # already built
        cfg = dict(cfg)
        obj_type = cfg.pop("type", None)
        if obj_type is None:
            raise KeyError(f"Config for registry {self.name} needs a 'type' key: {cfg}")
        if isinstance(obj_type, str):
            cls = self.get(obj_type)
            if cls is None:
                raise KeyError(f"'{obj_type}' is not registered in registry '{self.name}'. "
                               f"Available: {sorted(self._module_dict)}")
        elif inspect.isclass(obj_type) or callable(obj_type):
            cls = obj_type
        else:
            raise TypeError(f"Invalid type {obj_type!r} in config for registry {self.name}")
        kwargs = {**default_kwargs, **cfg}
        return cls(**kwargs)


# The port builds models only; codecs, datasets and the rest come with later
# slices.
MODELS = Registry("models")
