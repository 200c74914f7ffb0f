"""Scalar-logging backends of the runner.

The port's own ``LocalVisBackend`` and ``build_vis_backends``
(``probpose_code_tpu/visualization/vis_backends.py:27-60``, ``:99-107``;
mmengine's ``vis_backends`` config surface): the runner's train and val
scalars appended to ``<work_dir>/vis_data/scalars.json``, one JSON object a
line with its ``step``, as the JAX backend writes them. The TensorBoard
backend is not ported yet; a config that names another backend raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from probpose_code_torch.registry import VISUALIZERS


@VISUALIZERS.register_module()
class LocalVisBackend:
    def __init__(self, save_dir: Optional[str] = None):
        self.save_dir = save_dir or "."
        self._file = None

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        if self._file is None:
            os.makedirs(self.save_dir, exist_ok=True)
            self._file = open(os.path.join(self.save_dir, "scalars.json"), "a")
        rec = {k: float(v) for k, v in scalars.items()}
        rec["step"] = int(step)
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def build_vis_backends(cfg, work_dir: str) -> List[LocalVisBackend]:
    """The backends of ``cfg.visualizer.vis_backends``, each saving under
    ``<work_dir>/vis_data`` unless it names its own ``save_dir``."""
    backends = []
    for b in (cfg.get("visualizer") or {}).get("vis_backends", []) or []:
        b = dict(b)
        if VISUALIZERS.get(b.get("type")) is None:
            raise NotImplementedError(f"the {b.get('type')} backend is not ported yet (LocalVisBackend is)")
        b.setdefault("save_dir", os.path.join(work_dir, "vis_data"))
        backends.append(VISUALIZERS.build(b))
    return backends
