"""Padding in the encoder's batches counted by the program: 1 -
``encoder.samples_valid`` (the sum of the files' lengths) over
``encoder.samples_given`` (batch times padded length), in %: the in-program
twin of ``encoder.pad_share``. Moves audio_s_per_s.resynth."""

from port_bench.metrics import _recorded


def read(run):
    return _recorded.pad_share(run, "encoder.samples_valid", "encoder.samples_given")
