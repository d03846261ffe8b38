"""Hub-id resolution for the ``from_pretrained`` loaders.

Counterpart of speech_resynth_tpu/models/hub.py, without its download:

1. an existing local directory is returned as it is;
2. an ``org/name`` id is looked up in the HF cache layout
   (``cache_dir``, ``$HF_HUB_CACHE``, ``$HF_HOME/hub``,
   ``~/.cache/huggingface/hub``; ``models--org--name/snapshots/<sha>``,
   the one ``refs/main`` names first, else the newest snapshot);
3. anything else raises ``FileNotFoundError`` naming the roots it searched.
   The port never downloads (the JAX package tries ``snapshot_download``):
   copy the snapshot into a cache root or pass a directory.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional

_HUB_ID = re.compile(r"^[\w.\-]+/[\w.\-]+$")


def _cache_roots(cache_dir: Optional[str]) -> List[Path]:
    roots = []
    if cache_dir:
        roots.append(Path(cache_dir))
    if os.environ.get("HF_HUB_CACHE"):
        roots.append(Path(os.environ["HF_HUB_CACHE"]))
    if os.environ.get("HF_HOME"):
        roots.append(Path(os.environ["HF_HOME"]) / "hub")
    roots.append(Path.home() / ".cache" / "huggingface" / "hub")
    return roots


def _cached_snapshot(repo_id: str, root: Path) -> Optional[Path]:
    repo_dir = root / ("models--" + repo_id.replace("/", "--"))
    snapshots = repo_dir / "snapshots"
    if not snapshots.is_dir():
        return None
    ref = repo_dir / "refs" / "main"
    if ref.is_file():
        snap = snapshots / ref.read_text().strip()
        if snap.is_dir():
            return snap
    # no refs/main (a partial cache): the newest snapshot
    candidates = sorted((p for p in snapshots.iterdir() if p.is_dir()), key=lambda p: p.stat().st_mtime, reverse=True)
    return candidates[0] if candidates else None


def resolve_pretrained_dir(name_or_path, cache_dir: Optional[str] = None) -> Path:
    """A local directory, or the cached snapshot of an ``org/name`` hub id."""
    path = Path(name_or_path)
    if path.is_dir():
        return path
    name = str(name_or_path)
    if not _HUB_ID.match(name) or path.is_absolute():
        raise FileNotFoundError(
            f"pretrained checkpoint directory not found: {name!r} (not an existing directory, and not an 'org/name' hub id)"
        )
    roots = _cache_roots(cache_dir)
    for root in roots:
        snap = _cached_snapshot(name, root)
        if snap is not None:
            return snap
    raise FileNotFoundError(
        f"hub id {name!r} is not in any local HF cache (searched: {', '.join(str(r) for r in roots)}); "
        "nothing is downloaded: copy the checkpoint into one of the cache roots or pass a local directory"
    )
