"""Flax's parameter initializers on torch tensors, and the walk that draws a
module's random weights by the rules its model declares.

The JAX package declares an initializer at each parameter. Each of the
port's models declares the same distribution per parameter name
(``init_rules()``: ``(regular expression, initializer)`` pairs, the first
full match wins), and ``init_by_rules`` draws every parameter and buffer by
them. A tensor that no rule names is an error, so a new layer cannot fall
back to some default. The draws differ from the JAX package's (another
generator); the distributions do not.

Fans are read from the torch layout: a conv weight (O, I/groups, *K) has
fan_in I/groups * prod(K) and fan_out O * prod(K), a linear weight (O, I)
fan_in I and fan_out O. Flax's layouts, (*K, I/groups, O) and (I, O), give
the same numbers. A transposed conv's torch weight (I, O/groups, K) does not
fit that reading; the models draw those by ``normal`` only, which reads no fan.

Each initializer is ``init(shape, generator) -> tensor``: f32, drawn on the
generator's device (a CPU ``torch.Generator``, or a CUDA one for draws on the
card), copied into the parameter's dtype and device by ``init_by_rules``.
Every draw maps the generator's uniform draws one to one: the truncated
normal is drawn by the inverse CDF (``truncated_normal_``), as flax draws
it, and not by ``torch.nn.init.trunc_normal_``, which draws by inverse CDF
in torch 2.11 and by rejection in 2.13 (other values from one seed, so a
machine of each drew other discriminators).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Sequence, Tuple

import torch

Initializer = Callable[[Tuple[int, ...], torch.Generator], torch.Tensor]
Rules = Sequence[Tuple[str, Initializer]]

# the standard deviation of N(0, 1) truncated to (-2, 2), as flax divides by it
TRUNCATED_NORMAL_STD = 0.87962566103423978


def fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """(fan_in, fan_out) of a weight of at least two axes in the torch layout."""
    if len(shape) < 2:
        raise ValueError(f"a fan needs a weight of two or more axes, not the shape {tuple(shape)}")
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _empty(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)


def truncated_normal_(out: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` with N(0, 1) cut to [-2, 2] by the inverse CDF
    (``jax.random.truncated_normal``'s method): uniform draws between the
    bounds' CDFs (as 2 * CDF - 1), mapped through sqrt(2) * erfinv, one
    value for each uniform draw."""
    cdf_lo, cdf_hi = ((1.0 + math.erf(x / math.sqrt(2.0))) / 2.0 for x in (-2.0, 2.0))
    out.uniform_(2 * cdf_lo - 1, 2 * cdf_hi - 1, generator=generator).erfinv_().mul_(math.sqrt(2.0))
    return out.clamp_(-2.0, 2.0)


def variance_scaling(scale: float, mode: str, distribution: str) -> Initializer:
    """``jax.nn.initializers.variance_scaling(scale, mode, distribution)`` at
    its default axes, for the modes (``fan_in``, ``fan_avg``) and
    distributions (``truncated_normal``, ``uniform``) the initializers below
    use: variance scale / fan; a ``truncated_normal`` draw is cut at +-2 and
    scaled by sqrt(scale / fan) / 0.8796..., so its std is sqrt(scale / fan)."""
    if mode not in ("fan_in", "fan_avg") or distribution not in ("truncated_normal", "uniform"):
        raise ValueError(f"unknown mode {mode!r} or distribution {distribution!r}")

    def init(shape, generator: torch.Generator) -> torch.Tensor:
        fan_in, fan_out = fans(shape)
        std = math.sqrt(scale / (fan_in if mode == "fan_in" else (fan_in + fan_out) / 2))
        out = _empty(shape, generator)
        if distribution == "truncated_normal":
            return truncated_normal_(out, generator).mul_(std / TRUNCATED_NORMAL_STD)
        return out.uniform_(-1.0, 1.0, generator=generator).mul_(math.sqrt(3.0) * std)

    return init


def lecun_normal() -> Initializer:
    """``flax.linen.initializers.lecun_normal()`` (nn.Dense's default kernel):
    truncated normal, std sqrt(1 / fan_in)."""
    return variance_scaling(1.0, "fan_in", "truncated_normal")


def he_normal() -> Initializer:
    """``flax.linen.initializers.he_normal()``: truncated normal, std sqrt(2 / fan_in)."""
    return variance_scaling(2.0, "fan_in", "truncated_normal")


def glorot_uniform() -> Initializer:
    """``flax.linen.initializers.glorot_uniform()``: uniform, std sqrt(2 / (fan_in + fan_out))."""
    return variance_scaling(1.0, "fan_avg", "uniform")


def normal(stddev: float = 1e-2) -> Initializer:
    """``flax.linen.initializers.normal(stddev)``: N(0, stddev^2), no fan."""

    def init(shape, generator: torch.Generator) -> torch.Tensor:
        return _empty(shape, generator).normal_(generator=generator).mul_(stddev)

    return init


def embed_normal() -> Initializer:
    """``nn.Embed``'s default, ``variance_scaling(1.0, "fan_in", "normal",
    out_axis=0)`` on a (V, F) table: a plain normal of std 1 / sqrt(F)."""

    def init(shape, generator: torch.Generator) -> torch.Tensor:
        return _empty(shape, generator).normal_(generator=generator).mul_(1.0 / math.sqrt(shape[-1]))

    return init


def fan_in_normal() -> Initializer:
    """No flax initializer: the port's own seeded draw for the models that no
    entry point of either package draws at random (Whisper, UTMOS), N(0, 1 /
    fan_in) for a weight of two or more axes, N(0, 1) for one axis."""

    def init(shape, generator: torch.Generator) -> torch.Tensor:
        std = 1.0 if len(shape) < 2 else 1.0 / math.sqrt(fans(shape)[0])
        return _empty(shape, generator).normal_(generator=generator).mul_(std)

    return init


def zeros(shape, generator: torch.Generator) -> torch.Tensor:
    """``flax.linen.initializers.zeros``."""
    return torch.zeros(tuple(shape), device=generator.device)


def ones(shape, generator: torch.Generator) -> torch.Tensor:
    """``flax.linen.initializers.ones``."""
    return torch.ones(tuple(shape), device=generator.device)


# Whisper's and UTMOS's declared rules: the port's own seeded draw (biases 0,
# norm gains 1, ``fan_in_normal`` for every other tensor). No entry point of
# either package draws those two at random; the card check times them so.
FAN_IN_RULES = ((r".*bias", zeros), (r".*norm\.weight", ones), (r".+", fan_in_normal()))


@torch.no_grad()
def init_by_rules(module: torch.nn.Module, rules: Rules, generator: torch.Generator) -> None:
    """Every parameter, then every buffer, of ``module`` drawn by the first of
    ``rules`` whose pattern matches its name whole, in the module's order; a
    tensor no rule names raises ``KeyError``."""
    for name, t in [*module.named_parameters(), *module.named_buffers()]:
        init = next((init for pattern, init in rules if re.fullmatch(pattern, name)), None)
        if init is None:
            raise KeyError(f"{type(module).__name__} declares no initializer for {name!r}")
        t.copy_(init(tuple(t.shape), generator))
