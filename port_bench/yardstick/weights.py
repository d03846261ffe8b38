"""Seeded random weights, made on the card in one large draw per model.

A model's weights are listed by its plain reference as (name, shape, init)
entries, init one of ("normal", std), ("zeros",), ("ones",), ("const",
value). ``draw`` makes all of them from one generator: every normal entry is
a slice of one ``torch.randn`` call, scaled. The same dict goes to the
program (``load_state_dict``) and to the reference, so both run on the same
numbers; entries marked as buffers stay f32, the rest take ``dtype``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

Spec = List[Tuple[str, Tuple[int, ...], tuple, bool]]  # name, shape, init, is_buffer


def draw(torch, spec: Spec, generator, dtype) -> Dict[str, "torch.Tensor"]:
    dev = generator.device
    total = sum(math.prod(shape) for _, shape, init, _ in spec if init[0] == "normal")
    flat = torch.randn(total, generator=generator, device=dev, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape, init, is_buffer in spec:
        n = math.prod(shape)
        kind = init[0]
        if kind == "normal":
            t = flat[offset : offset + n].view(shape) * init[1]
            offset += n
        elif kind == "zeros":
            t = torch.zeros(shape, device=dev)
        elif kind == "ones":
            t = torch.ones(shape, device=dev)
        elif kind == "const":
            t = torch.full(shape, float(init[1]), device=dev)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
        out[name] = t if is_buffer else t.to(dtype)
    return out
