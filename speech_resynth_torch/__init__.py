"""speech_resynth_torch — the PyTorch/CUDA port of speech_resynth_tpu for NVIDIA Hopper.

The same capabilities as the JAX package, which stays the numerical
reference:

* speech resynthesis: waveform -> HuBERT/mHuBERT + k-means discrete units
  -> conditional-flow-matching log-mel decoder -> HiFi-GAN vocoder -> waveform
* speech language modeling: waveform -> deduplicated units -> unicode -> BPE
  -> Llama causal LM -> sWUGGY/sBLIMP scoring

Entry points run on the card (``cuda``) unless the caller asks for
``"cpu"``; without a card they raise rather than fall back.

Layering (bottom-up):
  core/       device, mesh (torch.distributed process groups), precision,
              rng, checkpoint, config, safetensors, metrics
  dsp/        mel frontend, resampler, VAD trim, audio I/O (C++ via ctypes)
  ops/        hand-written CUDA kernels (ops/csrc, built with nvcc at first
              launch) behind wrappers whose plain PyTorch versions serve CPU
              tensors: flash attention, fused MRF branch and stage, k-means
              assignment
  models/     CFM, transformer, HiFi-GAN, HuBERT, k-means, Llama, Whisper,
              UTMOS, checkpoint converters
  parallel/   tensor, fully sharded and pipeline parallelism over the mesh
  train/      the CFM, HiFi-GAN and speech-LM trainers
  text/       unit<->unicode mapping, WER/CER text normalization
  tokenizers/ C++ BPE trainer/encoder with ctypes bindings
  pipeline/   preprocessing, synthesis, serving, streaming, evaluation,
              training loops, the synthetic corpora and the end-to-end
              quality run
  cli/        stage runners (``speech-resynth-torch``, ``speech-lm-torch``)
  graft_entry the flagship decoder's entry and the multi-process dry run
"""

__version__ = "0.1.0"
