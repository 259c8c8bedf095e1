"""Checkpoint manager: keep the last k, find the latest, fall back past a
corrupt one.  The counterpart of ``repro.checkpoint.manager``, with the
same directory layout (``<root>/step_<n>/``)."""
from __future__ import annotations

import pathlib
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    """Saves trees under ``root/step_<step>`` and keeps the newest ``keep``
    of them."""

    def __init__(self, root, keep: int = 3):
        self.root = pathlib.Path(root)
        self.keep = keep
        self.root.mkdir(parents=True, exist_ok=True)

    # -- catalogue ---------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for p in self.root.iterdir():
            m = _STEP_RE.match(p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def path_for(self, step: int) -> pathlib.Path:
        return self.root / f"step_{step}"

    # -- save and restore --------------------------------------------------

    def save(self, tree: Any, step: int, metadata: Optional[Dict] = None):
        save_checkpoint(self.path_for(step), tree, step, metadata)
        self._gc()

    def restore_latest(self, target_tree: Any, device=None
                       ) -> Optional[Tuple[Any, int, Dict]]:
        """Restore the newest checkpoint that reads back; fall back to older
        ones past a corrupt one (a partial write).  None if none reads."""
        for step in reversed(self.steps()):
            try:
                return restore_checkpoint(self.path_for(step), target_tree,
                                          device)
            except Exception:  # noqa: BLE001 - corrupt: try the previous
                continue
        return None

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.path_for(s), ignore_errors=True)
