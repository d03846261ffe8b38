"""Reader and writer of the safetensors format, with no package beyond torch.

A file is an 8-byte little-endian header length, a JSON header that gives
each tensor's dtype, shape and byte range (``data_offsets``, relative to the
end of the header; an optional ``__metadata__`` entry of strings), then the
raw little-endian bytes. Published checkpoints (Whisper, mHuBERT) are such
files, so the port reads them itself. ``load_hf_state_dict`` also reads a
sharded checkpoint through its ``model.safetensors.index.json``.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
NAMES = {dtype: name for name, dtype in DTYPES.items()}

PathLike = Union[str, os.PathLike]


def load_file(path: PathLike) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the CPU, each in its own memory."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        start = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which this reader does not take")
            dtype, shape = DTYPES[info["dtype"]], info["shape"]
            begin, end = info["data_offsets"]
            count = 1
            for s in shape:
                count *= s
            if end - begin != count * dtype.itemsize:
                raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, not {count} x {dtype.itemsize}")
            buf = bytearray(end - begin)
            f.seek(start + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
            t = torch.frombuffer(buf, dtype=torch.uint8) if buf else torch.empty(0, dtype=torch.uint8)
            out[name] = t.view(dtype).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: PathLike, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; written from CPU copies) as one
    safetensors file, largest element size first as the reference writer
    orders them, so every tensor starts aligned to its element size."""
    items = sorted(tensors.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, dict] = {} if metadata is None else {"__metadata__": dict(metadata)}
    blobs = []
    offset = 0
    for name, t in items:
        if t.dtype not in NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}, which safetensors does not store")
        data = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for data in blobs:
            f.write(data)


def load_hf_state_dict(model_dir: PathLike) -> Dict[str, torch.Tensor]:
    """An HF checkpoint directory's weights: ``model.safetensors``, or the
    shards that ``model.safetensors.index.json`` names."""
    model_dir = Path(model_dir)
    single = model_dir / "model.safetensors"
    if single.is_file():
        return load_file(single)
    index = model_dir / "model.safetensors.index.json"
    if index.is_file():
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        sd: Dict[str, torch.Tensor] = {}
        for name in files:
            sd.update(load_file(model_dir / name))
        return sd
    raise FileNotFoundError(f"no safetensors weights (model.safetensors or its index) in {model_dir}")
