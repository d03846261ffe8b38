"""Text normalization and the WER/CER metrics.

The port's own copy of speech_resynth_tpu/text/normalize.py (pure Python;
the port imports nothing of the JAX package). Exact-order parity with the
reference's jiwer pipelines (its flow_matching/utils/misc.py:36-58) and its
tacotron-derived substitutions (utils/text.py:29-75): lowercase, number
expansion (with the year-style special cases), abbreviation expansion,
punctuation removal, contraction expansion, kaldi non-word removal,
whitespace normalization; WER/CER as total edit distance over total
reference length (jiwer aggregation semantics).

Two behaviors of the reference pipeline are subtle but load-bearing for
metric comparability, and are replicated deliberately:

1. jiwer.RemovePunctuation (misc.py:42) strips every Unicode category-P
   character, apostrophes included, BEFORE
   jiwer.ExpandCommonEnglishContractions (misc.py:43) runs. Every pattern
   in that transform contains an apostrophe, so contraction expansion is
   effectively a no-op in the reference: "don't" -> "dont", never "do not".
2. RemovePunctuation keeps ASCII symbols $ + < = > ^ ` | ~ (Unicode
   category S, not P). So jiwer.RemoveKaldiNonWords (misc.py:44) can still
   delete "<noise>"-style tokens, but "[noise]" has already lost its
   brackets and survives as the word "noise".

The number-to-words engine and the Levenshtein aggregation are written here,
so neither jiwer nor inflect is needed.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Sequence

# ---------------------------------------------------------------------------
# number to words
# ---------------------------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_SCALES = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"), (100, "hundred")]


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def number_to_words(n: int) -> str:
    """Plain English reading without 'and' (inflect andword='' mode)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 100:
        return _two_digits(n)
    parts: List[str] = []
    for scale, name in _SCALES:
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(number_to_words(q) + " " + name)
    if n:
        parts.append(_two_digits(n))
    return " ".join(parts)


def year_to_words(n: int) -> str:
    """Digit-pair reading for years (inflect group=2, zero='oh')."""
    s = str(n)
    if len(s) % 2 == 1:
        groups = [s[:1]] + [s[i : i + 2] for i in range(1, len(s), 2)]
    else:
        groups = [s[i : i + 2] for i in range(0, len(s), 2)]
    words = []
    for g in groups:
        v = int(g)
        if len(g) == 2 and g[0] == "0":
            words.append("oh " + _ONES[v] if v else "hundred")
        else:
            words.append(_two_digits(v) if len(g) == 2 else _ONES[v])
    return " ".join(words)


def _expand_number_match(m: re.Match) -> str:
    """Reference semantics (utils/text.py:33-45): special-case 1000<n<3000."""
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return year_to_words(num)
    return number_to_words(num)


_ABBREVIATIONS = [
    ("mrs", "missus"),
    ("mr", "mister"),
    ("dr", "doctor"),
    ("st", "saint"),
    ("co", "company"),
    ("jr", "junior"),
    ("maj", "major"),
    ("gen", "general"),
    ("drs", "doctors"),
    ("rev", "reverend"),
    ("lt", "lieutenant"),
    ("hon", "honorable"),
    ("sgt", "sergeant"),
    ("capt", "captain"),
    ("esq", "esquire"),
    ("ltd", "limited"),
    ("col", "colonel"),
    ("ft", "fort"),
]

_NUMBER_RE = re.compile(r"[0-9]+")
_ABBREV_RES = [(re.compile(rf"\b{a}\.", re.IGNORECASE), b) for a, b in _ABBREVIATIONS]

_KALDI_NONWORD_RE = re.compile(r"[<\[][^>\]]*[>\]]")


def remove_punctuation(text: str) -> str:
    """jiwer.RemovePunctuation semantics: delete every Unicode category-P
    character (apostrophes, brackets, curly quotes, …) and nothing else —
    ASCII symbols like ``$ + < = > ^ ` | ~`` are category S and survive."""
    return "".join(c for c in text if not unicodedata.category(c).startswith("P"))


def apply_substitutions(text: str) -> str:
    text = _NUMBER_RE.sub(_expand_number_match, text)
    for rx, repl in _ABBREV_RES:
        text = rx.sub(repl, text)
    return text


def wer_normalize(text: str) -> List[str]:
    """misc.py:36-48 pipeline (effective behavior) -> list of words."""
    text = text.lower()
    text = apply_substitutions(text)
    text = remove_punctuation(text)
    # jiwer.ExpandCommonEnglishContractions runs at this point in the
    # reference (misc.py:43), but every one of its patterns contains an
    # apostrophe that RemovePunctuation has already deleted — a no-op we
    # replicate by not expanding contractions at all (module docstring, #1).
    text = _KALDI_NONWORD_RE.sub("", text)  # only <...> forms can still match
    text = re.sub(r"\s+", " ", text).strip()
    return text.split(" ") if text else []

def cer_normalize(text: str) -> List[str]:
    """misc.py:50-58 pipeline -> list of chars (no whitespace collapsing)."""
    text = text.lower()
    text = apply_substitutions(text)
    text = remove_punctuation(text)
    return list(text.strip())


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (two-row DP)."""
    if not ref:
        return len(hyp)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (r != h))
        prev = cur
    return prev[-1]


def _corpus_metric(refs, hyps, normalize) -> float:
    total_edits = 0
    total_len = 0
    for r, h in zip(refs, hyps):
        rn, hn = normalize(r), normalize(h)
        total_edits += edit_distance(rn, hn)
        total_len += len(rn)
    return total_edits / max(total_len, 1)


def wer(refs: Sequence[str], hyps: Sequence[str]) -> float:
    return _corpus_metric(refs, hyps, wer_normalize)


def cer(refs: Sequence[str], hyps: Sequence[str]) -> float:
    return _corpus_metric(refs, hyps, cer_normalize)
