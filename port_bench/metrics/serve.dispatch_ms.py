"""Host ms a batch spends in ``decoder.synthesize``, the enqueue of its
kernels (with duration prediction it includes the frame bound's host sync),
averaged over the window's batches. Moves audio_s_per_s."""


def read(run):
    ms = [b[2] for b in run.records.get("batches", []) if b[2] is not None]
    return sum(ms) / len(ms) if ms else None
