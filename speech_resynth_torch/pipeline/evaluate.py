"""Resynthesis evaluation: WER, CER and MOS of hypotheses and references, as a CSV.

Counterpart of speech_resynth_tpu/pipeline/evaluate.py (the reference's
flow_matching/eval.py:22-96): ``evaluate`` resynthesizes the test set's
units in batches through the composite decoder, scores the MOS of the
hypotheses and of the reference waves, transcribes both, and writes the
six-row table (WER / CER / MOS of hyp and ref) with the scorer behind each
row, so a stand-in's numbers are never read as Whisper's or UTMOS's. The
CSV has the layout pandas' ``to_csv`` gives the JAX package's table (an
unnamed index column, ``score``, ``scorer``; NaN as an empty field) and is
written with ``csv``. ``_load_decoder`` finds the decoder a config names.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike
from ..models.composite import ConditionalFlowMatchingWithHifiGan
from ..text.normalize import cer, wer
from .data import UnitDataset
from .scorers import ASRScorer, MOSScorer, default_asr, default_mos

ROWS = ("WER (hyp)", "CER (hyp)", "MOS (hyp)", "WER (ref)", "CER (ref)", "MOS (ref)")
Row = Tuple[str, float, str]


def _load_decoder(config, device: DeviceLike = None) -> ConditionalFlowMatchingWithHifiGan:
    """The composite checkpoint directory ``flow_matching_with_hifigan.name``
    when it exists, else the two training-export directories
    (``<flow_matching.path>/hf`` and ``hifigan.path``)."""
    name = None
    try:
        name = config.flow_matching_with_hifigan.get("name")
    except (AttributeError, KeyError):
        pass
    name_error = None
    if name:
        try:
            return ConditionalFlowMatchingWithHifiGan.from_pretrained(str(name), device=device)
        except FileNotFoundError as exc:  # fall back to the training exports
            name_error = str(exc)
    fm_dir = Path(str(config.flow_matching.path)) / "hf"
    voc_dir = Path(str(config.hifigan.path))
    if (fm_dir / "config.json").is_file() and (voc_dir / "config.json").is_file():
        return ConditionalFlowMatchingWithHifiGan.load_pretrained(fm_dir, voc_dir, device=device)
    raise FileNotFoundError(
        "no decoder checkpoint found: flow_matching_with_hifigan.name "
        f"({name!r}) did not resolve"
        + (f" ({name_error})" if name_error else "")
        + f" and the training-export dirs are incomplete ({fm_dir}/config.json "
        f"and {voc_dir}/config.json must both exist)"
    )


def write_table(path, rows: Sequence[Row]) -> None:
    """The table as pandas' ``DataFrame.to_csv`` writes it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(["", "score", "scorer"])
        for name, score, scorer in rows:
            out.writerow([name, "" if np.isnan(score) else repr(float(score)), scorer])


def read_table(path) -> List[Row]:
    """A table written by ``write_table`` or by pandas."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))[1:]
    return [(name, float(score) if score else float("nan"), scorer) for name, score, scorer in rows]


def evaluate(
    config,
    decoder: Optional[ConditionalFlowMatchingWithHifiGan] = None,
    asr: Optional[ASRScorer] = None,
    mos: Optional[MOSScorer] = None,
    device: DeviceLike = None,
    noise: Optional[Callable[[int, tuple], torch.Tensor]] = None,
) -> List[Row]:
    """Score ``config.dataset.test_file`` (units, transcripts, reference
    waves under ``dataset.wav_dir``) and write ``config.eval.result_path``;
    returns the six (row, score, scorer) rows. The decoder is
    ``_load_decoder``'s on ``device`` unless given; the scorers are
    ``default_asr`` / ``default_mos`` unless given. The ODE noise of batch
    ``i`` is ``noise(i, shape)`` when given, else drawn from one generator
    on the decoder's device seeded 0."""
    dataset = UnitDataset(config.dataset.test_file, wav_dir=config.dataset.wav_dir, ext_audio=config.dataset.ext_audio)
    if decoder is None:
        decoder = _load_decoder(config, device=device)
    asr = asr if asr is not None else default_asr(config, device=decoder.device)
    mos = mos if mos is not None else default_mos(config, device=decoder.device)
    dt = float(config.flow_matching.dt)
    trunc = config.flow_matching.get("truncation_value")
    batch_size = int(config.flow_matching_with_hifigan.batch_size)
    generator = torch.Generator(device=decoder.device).manual_seed(0)

    transcripts, hyps, refs, hyp_scores, ref_scores = [], [], [], [], []
    for i, batch in enumerate(dataset.batches(batch_size, shuffle=False, drop_last=False)):
        ids = batch["input_ids"]
        x0 = None if noise is None else noise(i, (ids.shape[0], ids.shape[1], decoder.model.config.dim_in))
        wavs, lengths = decoder.synthesize(ids, dt=dt, truncation_value=trunc, generator=generator, x0=x0)
        wavs, lengths = wavs.float().cpu().numpy(), lengths.cpu().numpy()
        ref_wavs, ref_lengths = dataset.wav_batch(batch["names"])
        hyp_list = [w[: int(n)] for w, n in zip(wavs, lengths)]
        ref_list = [w[: int(max(n, 0))] for w, n in zip(ref_wavs, ref_lengths)]
        hyp_scores += [mos.score(w) for w in hyp_list]
        ref_scores += [mos.score(w) for w in ref_list]
        hyps += asr.transcribe(hyp_list)
        refs += asr.transcribe(ref_list)
        transcripts += batch["transcripts"]

    def mean(scores):
        return float(np.mean(scores)) if scores else float("nan")

    asr_name, mos_name = type(asr).__name__, type(mos).__name__
    scores = [wer(transcripts, hyps), cer(transcripts, hyps), mean(hyp_scores),
              wer(transcripts, refs), cer(transcripts, refs), mean(ref_scores)]
    rows = [(name, float(score), mos_name if name.startswith("MOS") else asr_name) for name, score in zip(ROWS, scores)]
    write_table(config.eval.result_path, rows)
    return rows
