"""Command-line tools, counterparts of the JAX package's ``scripts/``.

Each is a module run as ``python -m speech_resynth_torch.scripts.<name>``
with the JAX script's flags, defaults, subcommands and output files; a tool
that touches a device adds ``--device`` (the card unless ``cpu``):

* ``fit_kmeans``: a k-means unit codebook (``.npz``) fitted on encoder
  features of a wav glob;
* ``convert_checkpoints``: published HuBERT, k-means, composite, UTMOS and
  Whisper checkpoints into the local layout the loaders read;
* ``gan_longrun``: the long HiFi-GAN stability run, its report and its
  kill/resume checks.
"""
