"""Checkpoint manager (counterpart of speech_resynth_tpu/core/checkpoint.py).

The JAX package's interface on ``torch.save``: ``<dir>/<step>/state.pt``, one
directory per saved step, the newest ``max_to_keep`` kept. A save writes
into a temporary directory and renames it into place, so a run killed while
saving leaves every earlier checkpoint whole; a leftover temporary directory
has no digit name and is never read. Saves are synchronous: ``wait`` and
``close`` keep the JAX names and have nothing to wait for.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, List, Optional

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> List[int]:
        return sorted(
            int(p.name) for p in self._dir.iterdir() if p.name.isdigit() and (p / STATE_FILE).is_file()
        )

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save ``state.state_dict()`` (a ``train.common.TrainState``), or
        ``state`` itself when it is already a state dict (a host copy gathered
        from the processes, ``core.mesh.host_local_copy``), at ``step``. A
        step at or before the latest saved one is skipped
        unless ``force``, which replaces a checkpoint of the same step.
        Returns whether it saved."""
        latest = self.latest_step()
        if latest is not None and step <= latest and not force:
            return False
        tmp = self._dir / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state if isinstance(state, dict) else state.state_dict(), tmp / STATE_FILE)
        final = self._dir / str(step)
        if final.exists():
            old = self._dir / f".old-{step}-{os.getpid()}"
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
        for stale in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self._dir / str(stale))
        return True

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Load the checkpoint of ``step`` (the latest when None) into
        ``state_template`` (``load_state_dict``) and return it."""
        state_template.load_state_dict(self.read(step))
        return state_template

    def read(self, step: Optional[int] = None) -> dict:
        """The saved state dict of ``step`` (the latest when None), on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        return torch.load(self._dir / str(step) / STATE_FILE, map_location="cpu", weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def has_checkpoint(self) -> bool:
        return self.latest_step() is not None

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open between saves."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        self.close()
