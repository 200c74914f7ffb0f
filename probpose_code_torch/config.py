"""Python-file config system with ``_base_`` inheritance.

Mirrors the semantics the reference relies on from mmengine ``Config``:
config files are plain Python executed in an isolated namespace, a ``_base_``
list of relative paths is recursively loaded and deep-merged (child wins;
``_delete_=True`` in a child dict replaces instead of merging), and CLI
overrides are dotted-key assignments (``--cfg-options model.head.out_channels=17``).
See reference usage at ``tools/train.py:60-118`` and the ProbPose config
``configs/body_2d_keypoint/topdown_probmap/coco/td-pm_ProbPose-small_8xb64-210e_coco-256x192.py:11``.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List, Optional, Union

_DELETE_KEY = "_delete_"
_RESERVED = ("_base_", "__builtins__")


def _run_custom_imports(spec) -> None:
    """mmengine-style ``custom_imports``: import project modules so their
    registry decorators run (e.g. ``projects/example_project``). Accepts a
    dict ``{"imports": [...], "allow_failed_imports": bool}`` or a plain list."""
    if not spec:
        return
    import importlib

    if isinstance(spec, dict):
        modules = spec.get("imports", [])
        allow_failed = spec.get("allow_failed_imports", False)
    else:
        modules, allow_failed = spec, False
    if isinstance(modules, str):
        modules = [modules]
    for mod in modules:
        try:
            importlib.import_module(mod)
        except ImportError:
            if not allow_failed:
                raise


class Config(dict):
    """A dict with attribute access and deep-merge config semantics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def copy(self) -> "Config":
        return Config(copy.deepcopy(dict(self)))

    # -- loading ---------------------------------------------------------

    @staticmethod
    def fromfile(filename: Union[str, os.PathLike]) -> "Config":
        filename = os.path.abspath(os.fspath(filename))
        cfg_dict = _load_py(filename)
        _run_custom_imports(cfg_dict.get("custom_imports"))
        return Config(_wrap(cfg_dict))

    @staticmethod
    def fromdict(d: Dict[str, Any]) -> "Config":
        return Config(_wrap(copy.deepcopy(d)))

    # -- overrides -------------------------------------------------------

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Apply dotted-key overrides, e.g. ``{"model.head.sigma": 2.0}``."""
        for full_key, value in options.items():
            parts = full_key.split(".")
            node: Any = self
            for p in parts[:-1]:
                if isinstance(node, (list, tuple)):
                    node = node[int(p)]
                else:
                    if p not in node or not isinstance(node[p], (dict, list, tuple)):
                        node[p] = Config()
                    node = node[p]
            last = parts[-1]
            if isinstance(node, list):
                node[int(last)] = value
            else:
                node[last] = value

    def dump(self) -> str:
        """Render as pretty-printed python literals (for print_config tool)."""
        import pprint

        return pprint.pformat(_unwrap(self), width=100, sort_dicts=False)


def parse_cfg_option(kv: str) -> tuple:
    """Parse one ``key=value`` CLI item; value via literal_eval with str fallback."""
    key, _, raw = kv.partition("=")
    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw
    return key, value


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict) and not isinstance(obj, Config):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, Config):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_wrap(v) for v in obj)
    return obj


def _unwrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _unwrap(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unwrap(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unwrap(v) for v in obj)
    return obj


class _BaseProxy:
    """``_base_.<var>`` attribute access inside a config file (mmengine
    semantics, e.g. reference ``yoloxpose_tiny...py:36`` uses
    ``img_scale=_base_.input_size``). Values are deep-copied so child
    configs can mutate them freely."""

    def __init__(self, merged: Dict[str, Any]):
        object.__setattr__(self, "_merged", merged)

    def __getattr__(self, key: str) -> Any:
        try:
            return copy.deepcopy(object.__getattribute__(self, "_merged")[key])
        except KeyError:
            raise AttributeError(f"_base_ has no config key {key!r}")


def _load_py(filename: str) -> Dict[str, Any]:
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    with open(filename, "r", encoding="utf-8") as f:
        source = f.read()

    # Parse the ``_base_ = [...]`` literal up front so base configs are
    # loaded BEFORE the file body runs; the assignment is blanked out and
    # ``_base_`` rebound to an attribute proxy over the merged base dict.
    base_files: List[str] = []
    tree = ast.parse(source, filename)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            getattr(t, "id", None) == "_base_" for t in node.targets
        ):
            base_files = ast.literal_eval(node.value)
            lines = source.splitlines()
            for ln in range(node.lineno - 1, node.end_lineno):
                lines[ln] = ""
            source = "\n".join(lines)
            break
    if isinstance(base_files, str):
        base_files = [base_files]

    merged: Dict[str, Any] = {}
    for base in base_files:
        base_path = os.path.join(os.path.dirname(filename), base)
        merged = merge_dicts(merged, _load_py(os.path.abspath(base_path)))

    namespace: Dict[str, Any] = {"__file__": filename}
    if base_files:
        namespace["_base_"] = _BaseProxy(merged)
    code = compile(source, filename, "exec")
    exec(code, namespace)

    cfg = {
        k: v
        for k, v in namespace.items()
        if not k.startswith("__")
        and k not in _RESERVED
        and not _is_module_or_class(v)
        and not isinstance(v, _BaseProxy)
    }
    return merge_dicts(merged, cfg)


def _is_module_or_class(v: Any) -> bool:
    import types

    return isinstance(v, (types.ModuleType, type, types.FunctionType, types.BuiltinFunctionType))


def merge_dicts(base: Dict[str, Any], child: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge ``child`` into ``base`` (child wins). ``_delete_`` replaces."""
    out = copy.deepcopy(base)
    for key, value in child.items():
        if isinstance(value, dict):
            if value.get(_DELETE_KEY, False):
                value = {k: v for k, v in value.items() if k != _DELETE_KEY}
                out[key] = copy.deepcopy(value)
            elif key in out and isinstance(out[key], dict):
                out[key] = merge_dicts(out[key], value)
            else:
                out[key] = copy.deepcopy(value)
        else:
            out[key] = copy.deepcopy(value)
    return out
