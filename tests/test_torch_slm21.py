"""The port's sLM21 pair scoring and aggregation against the JAX package's.

The port reads and writes the tables with ``csv`` (no pandas); the JAX
package uses pandas. Cases: the JAX package's own (tests/test_slm21_native.py
and tests/test_pipeline.py::test_slm21_aggregation), the two packages
reading each other's tables, and a seeded gold table with tied pair means,
missing scores and a ``subset`` column. Accuracies and aggregates compare
exactly: both sides take the same float64 means.
"""

import numpy as np
import pandas as pd
import pytest

from speech_resynth_torch.pipeline import slm21_native as torch_slm21
from speech_resynth_torch.pipeline import speechlm as torch_speechlm
from speech_resynth_tpu.pipeline import slm21_native as jax_slm21
from speech_resynth_tpu.pipeline import speechlm as jax_speechlm


def _rows(frame: pd.DataFrame):
    """A gold DataFrame as the csv rows the port reads."""
    return [{k: str(v) for k, v in row.items()} for row in frame.to_dict("records")]


def test_score_pairs_accuracy():
    gold = pd.DataFrame({
        "id": [1, 1, 2, 2, 3, 3, 4, 4],
        "filename": [f"f{i}.wav" for i in range(8)],
        "correct": [1, 0, 1, 0, 1, 0, 1, 0],
        "frequency": ["high", "high", "high", "high", "oov", "oov", "oov", "oov"],
    })
    # pairs 1 and 3 scored right, 2 and 4 wrong
    scores = {"f0": -1.0, "f1": -2.0, "f2": -3.0, "f3": -1.0, "f4": -0.5, "f5": -4.0, "f6": -9.0, "f7": -1.0}
    table = torch_slm21.score_pairs(_rows(gold), scores, "frequency")
    assert table == {"high": (2, 0.5), "oov": (2, 0.5)}
    theirs = jax_slm21.score_pairs(gold, scores, "frequency")
    assert table == {k: (int(r["n"]), float(r["score"])) for k, r in theirs.iterrows()}


def _write_task_tree(tmp_path, writer):
    lex_dir, syn_dir = tmp_path / "lexical", tmp_path / "syntactic"
    lex_dir.mkdir()
    syn_dir.mkdir()
    writer(pd.DataFrame({"id": [1, 1, 2, 2], "filename": ["a.wav", "b.wav", "c.wav", "d.wav"], "correct": [1, 0, 1, 0],
                         "frequency": ["high", "high", "oov", "oov"]}), lex_dir / "gold.csv")
    writer(pd.DataFrame({"id": [1, 1], "filename": ["s1.wav", "s2.wav"], "correct": [1, 0], "type": ["anaphor"] * 2}),
           syn_dir / "gold.csv")
    result_dir = tmp_path / "results"
    (result_dir / "lexical").mkdir(parents=True)
    (result_dir / "syntactic").mkdir(parents=True)
    (result_dir / "lexical/test.txt").write_text("a -1.0\nb -2.0\nc -5.0\nd -1.0\n")
    (result_dir / "syntactic/test.txt").write_text("s1 -0.2\ns2 -0.9\n")
    return lex_dir, syn_dir, result_dir


def test_end_to_end_native_scoring(tmp_path):
    lex_dir, syn_dir, result_dir = _write_task_tree(tmp_path, lambda df, path: df.to_csv(path, index=False))
    assert torch_slm21.run_native_slm21(result_dir, lex_dir, syn_dir, "test")
    out = torch_speechlm.aggregate_slm21_scores(result_dir, "test")
    # lexical: pair 1 right, pair 2 wrong -> all 0.5, in-vocab (high) 1.0, oov 0.0
    assert out == {"sWUGGY all": 0.5, "sWUGGY in-vocab": 1.0, "sWUGGY out-of-vocab": 0.0, "sBLIMP": 1.0}


def test_missing_gold_returns_false(tmp_path):
    assert not torch_slm21.run_native_slm21(tmp_path, tmp_path / "nope", None, "test")


def test_read_score_file(tmp_path):
    p = tmp_path / "s.txt"
    p.write_text("a -1.5\nb 0.25\n\n")
    assert torch_slm21.read_score_file(p) == jax_slm21.read_score_file(p) == {"a": -1.5, "b": 0.25}


def test_slm21_aggregation(tmp_path):
    """Weighted means over categories; the table written without pandas reads back equal."""
    scores = tmp_path / "scores"
    scores.mkdir()
    torch_slm21.write_table(scores / "score_lexical_test_by_frequency.csv", {"high": (30, 0.9), "oov": (10, 0.5)}, "frequency")
    torch_slm21.write_table(scores / "score_syntactic_test_by_type.csv", {"t1": (5, 0.6), "t2": (15, 0.8)}, "type")
    out = torch_speechlm.aggregate_slm21_scores(tmp_path, "test")
    assert out["sWUGGY all"] == pytest.approx((10 * 0.5 + 30 * 0.9) / 40)
    assert out["sWUGGY in-vocab"] == pytest.approx(0.9)
    assert out["sWUGGY out-of-vocab"] == pytest.approx(0.5)
    assert out["sBLIMP"] == pytest.approx((5 * 0.6 + 15 * 0.8) / 20)
    assert (tmp_path / "scores/score.csv").is_file()
    assert torch_slm21.read_table(scores / "score_syntactic_test_by_type.csv") == {"t1": (5, 0.6), "t2": (15, 0.8)}


def test_aggregate_without_oov_is_nan_as_in_jax(tmp_path):
    scores = tmp_path / "scores"
    scores.mkdir()
    torch_slm21.write_table(scores / "score_lexical_test_by_frequency.csv", {"high": (3, 2 / 3)}, "frequency")
    torch_slm21.write_table(scores / "score_syntactic_test_by_type.csv", {"t1": (4, 0.25)}, "type")
    ours = torch_speechlm.aggregate_slm21_scores(tmp_path, "test")
    ours_csv = (scores / "score.csv").read_text()
    theirs = jax_speechlm.aggregate_slm21_scores(tmp_path, "test")
    assert np.isnan(ours["sWUGGY out-of-vocab"])
    np.testing.assert_array_equal(list(ours.values()), theirs[0].to_numpy())
    assert ours_csv == (scores / "score.csv").read_text()  # the JAX package rewrote it: byte-equal


@pytest.mark.parametrize("direction", ["jax_reads_port", "port_reads_jax"])
def test_each_package_reads_the_others_tables(tmp_path, direction):
    """The JAX aggregation on the port's CSVs, and the port's on the JAX
    package's, give the four numbers each gives on its own."""
    lex_dir, syn_dir, result_dir = _write_task_tree(tmp_path, lambda df, path: df.to_csv(path, index=False))
    writer, reader = (torch_slm21, jax_speechlm) if direction == "jax_reads_port" else (jax_slm21, torch_speechlm)
    assert writer.run_native_slm21(result_dir, lex_dir, syn_dir, "test")
    crossed = reader.aggregate_slm21_scores(result_dir, "test")
    own_dir = tmp_path / "own"
    (own_dir / "lexical").mkdir(parents=True)
    (own_dir / "syntactic").mkdir()
    for task in ("lexical", "syntactic"):
        (own_dir / task / "test.txt").write_text((result_dir / task / "test.txt").read_text())
    own_writer = jax_slm21 if reader is jax_speechlm else torch_slm21
    assert own_writer.run_native_slm21(own_dir, lex_dir, syn_dir, "test")
    own = reader.aggregate_slm21_scores(own_dir, "test")
    values = (lambda r: list(r.values())) if reader is torch_speechlm else (lambda r: list(r[0].to_numpy()))
    assert values(crossed) == values(own)
    for name in ("score_lexical_test_by_frequency.csv", "score_syntactic_test_by_type.csv"):
        assert (result_dir / "scores" / name).read_text() == (own_dir / "scores" / name).read_text()


def test_seeded_gold_with_ties_missing_scores_and_subsets(tmp_path):
    """300 pairs of 1-3 members a side: tied means (not correct), scores
    missing (dropped; pairs left one-sided are skipped), two subsets (only
    this split's rows count); tables equal to the JAX package's, byte for byte."""
    rng = np.random.default_rng(40)
    rows, scores = [], {}
    for pid in range(300):
        members = [(1, j) for j in range(int(rng.integers(1, 4)))] + [(0, j) for j in range(int(rng.integers(1, 4)))]
        freq = ["high", "mid", "low", "oov"][pid % 4]
        tie = pid % 7 == 0
        for correct, j in members:
            name = f"p{pid}_{correct}_{j}"
            rows.append({"id": pid, "filename": f"{name}.wav", "correct": correct, "frequency": freq,
                         "subset": "dev" if pid % 11 == 0 else "test"})
            if rng.random() > 0.1:
                scores[name] = -1.0 if tie else float(np.round(rng.normal(-3, 1), 2))
    gold = pd.DataFrame(rows)
    result_dir = tmp_path / "results"
    (result_dir / "lexical").mkdir(parents=True)
    (result_dir / "lexical/test.txt").write_text("".join(f"{k} {v}\n" for k, v in scores.items()))
    gold.to_csv(tmp_path / "gold.csv", index=False)
    assert torch_slm21.run_native_slm21(result_dir, tmp_path, None, "test")
    ours = (result_dir / "scores/score_lexical_test_by_frequency.csv").read_text()
    assert jax_slm21.run_native_slm21(result_dir, tmp_path, None, "test")
    theirs = (result_dir / "scores/score_lexical_test_by_frequency.csv").read_text()
    assert ours == theirs
    table = torch_slm21.read_table(result_dir / "scores/score_lexical_test_by_frequency.csv")
    assert list(table) == ["high", "low", "mid", "oov"] and sum(n for n, _ in table.values()) < 300
    test_gold = gold[gold["subset"] == "test"]
    assert torch_slm21.score_pairs(_rows(test_gold), scores, "frequency") == table
