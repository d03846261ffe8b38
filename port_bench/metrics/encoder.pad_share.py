"""Padding in the encoder's batches: 1 - the files' samples over the samples
the encoder was given (every batch padded to 30 s by SpeechDataset), over
the window's batches, in %. Moves audio_s_per_s.resynth."""

from port_bench.yardstick import readers


def read(run):
    shapes = run.records.get("encoder_shapes", [])
    given = sum(b * t for b, t, _, _ in shapes)
    return readers.share(given - sum(valid for _, _, valid, _ in shapes), given)
