"""The narrow MRF stages' share of their roofline in the resynthesis cell (the
reader of ``mrf_roofline``), in %. Moves audio_s_per_s.resynth."""

from port_bench.harness import load_by_path

read = load_by_path("metrics", "mrf_roofline").read
