"""Byte-level BPE over unit strings: ctypes bindings of a C++ trainer and encoder.

The port's copy of speech_resynth_tpu/tokenizers/bpe.py over its own copy of
``csrc/bpe.cpp``: whole-line words, a fixed initial alphabet, a target
vocabulary size, encoding to ids, and JSON save/load in the HF
``tokenizer.json`` schema, so the files interoperate with the JAX package's
tokenizer and HF ``tokenizers`` both ways.

The library is built with ``g++`` at first use into ``<repo>/build/
torch_kernels/`` (``.gitignore`` lists ``build/``), never into the source
tree; its file name carries a hash of the source. Nothing is built when the
module is imported.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import threading
from pathlib import Path
from typing import Iterable, List, Sequence

from ..ops.build import cached_library

CSRC = Path(__file__).resolve().parent / "csrc"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def build_library() -> Path:
    """Compile the BPE library (or reuse one built from the identical source)."""
    sources = [CSRC / "bpe.cpp"]

    def compile_to(out: Path) -> None:
        done = subprocess.run(["g++", *GXX_FLAGS, *map(str, sources), "-o", str(out)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed to build the BPE library:\n{done.stdout}{done.stderr}")

    return cached_library("libsrt_bpe", sources, GXX_FLAGS, compile_to)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.bpe_train_from_lines.restype = ctypes.c_void_p
            lib.bpe_train_from_lines.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint64,
                ctypes.c_uint32,
            ]
            lib.bpe_free.argtypes = [ctypes.c_void_p]
            lib.bpe_vocab_size.restype = ctypes.c_uint32
            lib.bpe_vocab_size.argtypes = [ctypes.c_void_p]
            lib.bpe_token.restype = ctypes.c_uint32
            lib.bpe_token.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32]
            lib.bpe_num_merges.restype = ctypes.c_uint64
            lib.bpe_num_merges.argtypes = [ctypes.c_void_p]
            lib.bpe_merge.argtypes = [
                ctypes.c_void_p,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.bpe_encode.restype = ctypes.c_uint64
            lib.bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64]
            lib.bpe_from_vocab.restype = ctypes.c_void_p
            lib.bpe_from_vocab.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint64,
            ]
            _lib = lib
        return _lib


class BpeTokenizer:
    """A BPE model held by the C++ library."""

    def __init__(self, handle: int):
        self._lib = _load()
        self._h = ctypes.c_void_p(handle)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bpe_free(self._h)
            self._h = None

    # -- training ------------------------------------------------------------

    @classmethod
    def train(cls, lines: Iterable[str], vocab_size: int, initial_alphabet: Sequence[str] = ()) -> "BpeTokenizer":
        """Train on ``lines`` (each one word) up to ``vocab_size`` tokens."""
        lib = _load()
        lines = [line.rstrip("\n") for line in lines]
        arr = (ctypes.c_char_p * len(lines))(*[line.encode("utf-8") for line in lines])
        alpha = [ord(c) for c in initial_alphabet]
        alpha_arr = (ctypes.c_uint32 * len(alpha))(*alpha)
        return cls(lib.bpe_train_from_lines(arr, len(lines), alpha_arr, len(alpha), vocab_size))

    @classmethod
    def train_files(cls, files: Sequence[str], vocab_size: int, initial_alphabet: Sequence[str] = ()) -> "BpeTokenizer":
        """Train on the lines of ``files``."""
        lines: List[str] = []
        for f in files:
            with open(f, encoding="utf-8") as fh:
                lines.extend(line.rstrip("\n") for line in fh)
        return cls.train(lines, vocab_size, initial_alphabet)

    # -- inference -----------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        """Token ids of ``text`` (no unknown token: characters outside the
        alphabet are dropped)."""
        data = text.encode("utf-8")
        cap = max(len(text), 1)  # at most one token per character
        out = (ctypes.c_uint32 * cap)()
        n = self._lib.bpe_encode(self._h, data, out, cap)
        if n > cap:  # the library returns the full count: ask again with room for it
            out = (ctypes.c_uint32 * n)()
            n = self._lib.bpe_encode(self._h, data, out, n)
        return list(out[:n])

    @property
    def vocab_size(self) -> int:
        return self._lib.bpe_vocab_size(self._h)

    def token(self, token_id: int) -> str:
        """The string of token ``token_id``."""
        buf = ctypes.create_string_buffer(64)
        n = self._lib.bpe_token(self._h, token_id, buf, 64)
        if n > 64:
            buf = ctypes.create_string_buffer(n)
            self._lib.bpe_token(self._h, token_id, buf, n)
        return buf.raw[:n].decode("utf-8")

    def get_vocab(self) -> dict:
        return {self.token(i): i for i in range(self.vocab_size)}

    def merges(self) -> List[tuple]:
        """(left id, right id) of every merge, in rank order."""
        left, right = ctypes.c_uint32(), ctypes.c_uint32()
        out = []
        for r in range(self._lib.bpe_num_merges(self._h)):
            self._lib.bpe_merge(self._h, r, ctypes.byref(left), ctypes.byref(right))
            out.append((left.value, right.value))
        return out

    # -- serialization (HF tokenizer.json schema) ------------------------------

    def save(self, path: str) -> None:
        vocab = self.get_vocab()
        id_to_tok = {i: t for t, i in vocab.items()}
        merges = [[id_to_tok[a], id_to_tok[b]] for a, b in self.merges()]
        doc = {
            "version": "1.0",
            "truncation": None,
            "padding": None,
            "added_tokens": [],
            "normalizer": None,
            "pre_tokenizer": None,
            "post_processor": None,
            "decoder": None,
            "model": {
                "type": "BPE",
                "dropout": None,
                "unk_token": None,
                "continuing_subword_prefix": None,
                "end_of_word_suffix": None,
                "fuse_unk": False,
                "byte_fallback": False,
                "ignore_merges": False,
                "vocab": vocab,
                "merges": merges,
            },
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, ensure_ascii=False)

    @classmethod
    def from_file(cls, path: str) -> "BpeTokenizer":
        """Read a ``tokenizer.json`` (merges as pairs or as "a b" strings)."""
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        model = doc.get("model", doc)
        vocab, merges = model["vocab"], model["merges"]
        id_to_tok = [None] * len(vocab)
        for t, i in vocab.items():
            id_to_tok[i] = t
        lib = _load()
        toks = (ctypes.c_char_p * len(id_to_tok))(*[t.encode("utf-8") for t in id_to_tok])
        flat = []
        for m in merges:
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            flat += [vocab[a], vocab[b]]
        pairs = (ctypes.c_uint32 * len(flat))(*flat)
        handle = lib.bpe_from_vocab(toks, len(id_to_tok), pairs, len(merges))
        if not handle:
            raise ValueError(f"inconsistent vocab/merges in {path}")
        return cls(handle)
