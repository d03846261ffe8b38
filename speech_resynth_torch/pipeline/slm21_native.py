"""sLM21 pair scoring (sWUGGY / sBLIMP) without pandas.

Counterpart of speech_resynth_tpu/pipeline/slm21_native.py. Each row of a
task's ``gold.csv`` names an audio file (``filename``), its pair (``id``),
whether it is the pair's ``correct`` member, and its category (``frequency``
for the lexical task, ``type`` for the syntactic one). A pair counts as
correct when the mean score of its correct members is strictly greater than
that of its incorrect members; pairs missing one side are skipped. The
tables are read with ``csv`` and written in the layout pandas gives them
(``frequency,n,score`` / ``type,n,score``, floats as ``repr``), so the JAX
package's aggregation reads the port's tables and the port's reads its.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

Table = Dict[str, Tuple[int, float]]  # category -> (pairs, accuracy), in groupby order


def read_score_file(path) -> Dict[str, float]:
    """'name score' lines -> {name: score}."""
    scores: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                scores[parts[0]] = float(parts[1])
    return scores


def _truth(value: str) -> bool:
    """A ``correct`` cell as pandas reads it and ``astype(bool)`` casts it."""
    value = value.strip()
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return float(value) != 0.0


def _sort_key(keys: List[str]):
    """groupby's order: numeric when every key reads as a number, else by string."""
    try:
        for k in keys:
            float(k)
    except ValueError:
        return str
    return float


def score_pairs(gold: List[Dict[str, str]], scores: Dict[str, float], by: str) -> Table:
    """Pairwise accuracy by ``by``. ``gold`` rows (``csv.DictReader``) need
    ``filename`` (its stem is the score file's name), ``id``, ``correct`` and
    ``by``; rows without a score are dropped, and so are empty ids and
    categories, as groupby drops NaN keys."""
    pairs: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for row in gold:
        score = scores.get(Path(row["filename"]).stem)
        if score is None or math.isnan(score) or row["id"] == "":
            continue
        pairs.setdefault(row["id"], []).append((row, score))

    results: Dict[str, List[bool]] = {}
    for rows in pairs.values():
        corr = np.array([s for r, s in rows if _truth(r["correct"])], np.float64)
        incorr = np.array([s for r, s in rows if not _truth(r["correct"])], np.float64)
        if corr.size == 0 or incorr.size == 0:
            continue
        if rows[0][0][by] != "":
            results.setdefault(rows[0][0][by], []).append(bool(corr.mean() > incorr.mean()))
    return {k: (len(results[k]), float(np.mean(np.array(results[k], np.float64))))
            for k in sorted(results, key=_sort_key(list(results)))}


def write_table(path, table: Table, by: str) -> None:
    with open(path, "w", newline="") as f:
        f.write(f"{by},n,score\n")
        for key, (n, score) in table.items():
            f.write(f"{key},{n},{score!r}\n")


def read_table(path) -> Table:
    """A ``<category>,n,score`` table (the port's or pandas')."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {r[0]: (int(r[1]), float(r[2])) for r in rows[1:] if r}


def run_native_slm21(
    result_dir,
    dataset_dir_lexical: Optional[str] = None,
    dataset_dir_syntactic: Optional[str] = None,
    split: str = "test",
) -> bool:
    """Write ``scores/score_lexical_<split>_by_frequency.csv`` and
    ``scores/score_syntactic_<split>_by_type.csv`` from each task's
    ``gold.csv`` (only its rows of this ``subset`` when it has that column)
    and ``<task>/<split>.txt``; False when no task had both files."""
    result_dir = Path(result_dir)
    jobs = []
    if dataset_dir_lexical is not None:
        jobs.append(("lexical", Path(dataset_dir_lexical) / "gold.csv", "frequency", f"score_lexical_{split}_by_frequency.csv"))
    if dataset_dir_syntactic is not None:
        jobs.append(("syntactic", Path(dataset_dir_syntactic) / "gold.csv", "type", f"score_syntactic_{split}_by_type.csv"))

    wrote = False
    for task, gold_path, by, out_name in jobs:
        score_path = result_dir / task / f"{split}.txt"
        if not gold_path.is_file() or not score_path.is_file():
            continue
        with open(gold_path, newline="") as f:
            gold = [row for row in csv.DictReader(f) if row.get("subset", split) == split]
        out_dir = result_dir / "scores"
        out_dir.mkdir(parents=True, exist_ok=True)
        write_table(out_dir / out_name, score_pairs(gold, read_score_file(score_path), by), by)
        wrote = True
    return wrote
