"""Padding in the server's batches: 1 - the frames the requests need over the
frames computed (batch rows x the batch's frame count), over every batch the
window dispatched. Moves audio_s_per_s."""

from port_bench.yardstick import readers


def read(run):
    batches = readers.served_batches(run)
    computed = sum(len(b["rows"]) * b["frames"] for b in batches if b["frames"])
    needed = sum(run.records["frames"].values())
    return readers.share(computed - needed, computed)
