"""The models' public names, as speech_resynth_tpu/models/__init__.py
exports them."""

from .cfm import CFMConfig, ConditionalFlowMatchingModel
from .composite import ConditionalFlowMatchingWithHifiGan
from .hifigan import (
    HifiGanConfig,
    HifiGanGenerator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from .hubert import HubertConfig, HubertEncoder
from .kmeans import KMeansQuantizer, kmeans_fit
from .llama import (
    LlamaConfig,
    LlamaLM,
    causal_lm_loss,
    greedy_decode,
    lookup_decode,
    lookup_sample_decode,
    sample_decode,
    sequence_pseudo_log_prob,
)
from .speech_encoder import SpeechEncoder, embedding, load_encoder

__all__ = [
    "CFMConfig",
    "ConditionalFlowMatchingModel",
    "ConditionalFlowMatchingWithHifiGan",
    "HifiGanConfig",
    "HifiGanGenerator",
    "MultiPeriodDiscriminator",
    "MultiScaleDiscriminator",
    "discriminator_loss",
    "feature_loss",
    "generator_loss",
    "HubertConfig",
    "HubertEncoder",
    "KMeansQuantizer",
    "kmeans_fit",
    "LlamaConfig",
    "LlamaLM",
    "causal_lm_loss",
    "greedy_decode",
    "lookup_decode",
    "lookup_sample_decode",
    "sample_decode",
    "sequence_pseudo_log_prob",
    "SpeechEncoder",
    "embedding",
    "load_encoder",
]
