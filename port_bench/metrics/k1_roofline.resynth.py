"""K1's share of its roofline in the resynthesis cell (the reader of
``k1_roofline``: the decoder's launches and the encoder's), in %. Moves
audio_s_per_s.resynth."""

from port_bench.harness import load_by_path

read = load_by_path("metrics", "k1_roofline").read
