"""Host ms a batch spends reading its WAVs (``audio_io.read_batch``) and
writing its outputs (``audio_io.write``, once a file), each wrapped from
outside, averaged over the window's batches. Moves audio_s_per_s.resynth."""


def read(run):
    return run.records.get("io_ms")
