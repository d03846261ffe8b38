"""Share of the resynthesis cell's traced window in which no operation ran on
the card (the reader of ``device.idle.serve``), in %. Moves
audio_s_per_s.resynth."""

from port_bench.harness import load_by_path

read = load_by_path("metrics", "device.idle.serve").read
