"""PyTorch/CUDA port of speech_resynth_tpu (unit-to-waveform resynthesis on NVIDIA Hopper)."""

__version__ = "0.1.0"
