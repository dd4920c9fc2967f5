"""The host preprocessing and WordPiece core in C++, loaded with ctypes
(retr_tpu/native/__init__.py on the port's own copy of the sources).

``preprocess.cc`` (pad to square, PIL-exact uint8 resize, the reference's mask
resize, a threaded batch API) and ``tokenizer.cc`` (BERT basic tokenization and
greedy WordPiece for ASCII text) sit beside this file. Each is compiled with g++
on first use into ``retr_tpu_torch/_build/`` under a name that carries a hash of
the source, the flags and the host's instruction set (the build uses
``-march=native``), so an edited source or another host's CPU gets its own
library. Each build writes a temporary file and renames it, so processes that
load at once all get a whole library. Nothing is built at import.

The numpy image code (``ops/image.py``) and the Python tokenizer are the
executable spec the native core bit-matches (tests/test_torch_native.py). Where
the library cannot be built or loaded (no g++), :func:`load` raises
:class:`Unavailable` and callers use the spec; a failure inside a call raises.
ctypes releases the GIL for the length of each call, so preprocessing overlaps
the other threads of a server.

    g++ -O3 -shared -fPIC -std=c++17 -march=native -o lib.so preprocess.cc -lpthread
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from typing import Dict

import numpy as np

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(SRC_DIR), "_build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
ARCH_FLAGS = (["-march=native"], [])     # the first that compiles; the output is bit-identical

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_failed: Dict[str, str] = {}
_log = logging.getLogger(__name__)
_warned = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
SIGNATURES = {  # library -> C function -> (argtypes, restype)
    "preprocess": {
        "retr_pad_resize_image": ([_u8p] + [ctypes.c_int] * 4 + [_u8p], ctypes.c_int),
        "retr_pad_resize_mask": ([_u8p] + [ctypes.c_int] * 3 + [_u8p], ctypes.c_int),
        "retr_pad_resize_batch": ([_u8p, _i64p, _i32p, _i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   _u8p, ctypes.c_int], ctypes.c_int),
    },
    "tokenizer": {
        "retr_tok_create": ([ctypes.c_char_p], ctypes.c_void_p),
        "retr_tok_destroy": ([ctypes.c_void_p], None),
        "retr_tok_encode": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, _i32p], ctypes.c_int),
        "retr_tok_encode_batch": ([ctypes.c_void_p, ctypes.c_char_p, _i64p, ctypes.c_int, ctypes.c_int,
                                   _i32p, _i32p, ctypes.c_int], ctypes.c_int),
    },
}


class Unavailable(RuntimeError):
    """The native library could not be built or loaded on this host."""


def _host_isa() -> bytes:
    """The machine and its CPU's feature flags: a library built with
    ``-march=native`` runs only where these match."""
    flags = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            flags = next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        pass
    return platform.machine().encode() + b"\0" + flags


def library_path(name: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(SRC_DIR, f"{name}.cc"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS + ARCH_FLAGS[0]).encode() + b"\0" + _host_isa())
    return os.path.join(BUILD_DIR, f"libretr_{name}-{h.hexdigest()[:16]}.so")


def _build(name: str) -> str:
    """Compile ``<name>.cc`` unless its hashed library exists; returns its path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    errors = []
    for arch in ARCH_FLAGS:
        cmd = ["g++", *FLAGS, *arch, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cc"), "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            errors.append(f"{' '.join(cmd)}: {exc}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
        errors.append(f"{' '.join(cmd)}:\n{proc.stderr}")
    raise Unavailable("g++ could not build " + f"{name}.cc:\n" + "\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``<name>.cc`` ("preprocess" or "tokenizer");
    one handle per process. Raises :class:`Unavailable` when that fails, and
    again on every later call without retrying."""
    with _lock:
        if name in _libs:
            return _libs[name]
        if name in _failed:
            raise Unavailable(_failed[name])
        try:
            lib = ctypes.CDLL(_build(name))
        except (Unavailable, OSError) as exc:
            _failed[name] = str(exc)
            raise Unavailable(str(exc)) from exc
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib


def available(name: str = "preprocess") -> bool:
    """Whether the library loads. The first time it does not, the reason is
    logged once (the callers then run the numpy or Python spec)."""
    global _warned
    try:
        load(name)
        return True
    except Unavailable as exc:
        if not _warned:
            _warned = True
            _log.warning("native %s core unavailable; using the Python spec: %s", name, exc)
        return False


def _ptr(a: np.ndarray, ptype=_u8p):
    return a.ctypes.data_as(ptype)


def _check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} failed rc={rc}")


def pad_resize_image(img: np.ndarray, out_size: int) -> np.ndarray:
    """uint8 [H, W, C] -> [out, out, C] uint8: pad to square, PIL-exact resize."""
    lib = load("preprocess")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3:
        raise ValueError(f"expected an [H, W, C] image, got shape {img.shape}")
    h, w, c = img.shape
    dst = np.empty((out_size, out_size, c), np.uint8)
    _check(lib.retr_pad_resize_image(_ptr(img), h, w, c, out_size, _ptr(dst)), "retr_pad_resize_image")
    return dst


def pad_resize_mask(mask: np.ndarray, out_size: int) -> np.ndarray:
    """bool [H, W] -> [out, out] bool with the reference's mask-resize semantics."""
    lib = load("preprocess")
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    if m.ndim != 2:
        raise ValueError(f"expected an [H, W] mask, got shape {m.shape}")
    h, w = m.shape
    dst = np.empty((out_size, out_size), np.uint8)
    _check(lib.retr_pad_resize_mask(_ptr(m), h, w, out_size, _ptr(dst)), "retr_pad_resize_mask")
    return dst.astype(bool)


def pad_resize_image_batch(images, out_size: int, n_threads: int = 4) -> np.ndarray:
    """Variable-size uint8 [H, W, C] images (one C) -> [N, out, out, C] uint8."""
    lib = load("preprocess")
    images = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    if not images or any(im.ndim != 3 or im.shape[2] != images[0].shape[2] for im in images):
        raise ValueError("expected one or more [H, W, C] images with one channel count")
    c = images[0].shape[2]
    data = np.concatenate([im.reshape(-1) for im in images])
    offsets = np.cumsum([0] + [im.size for im in images[:-1]]).astype(np.int64)
    heights = np.asarray([im.shape[0] for im in images], np.int32)
    widths = np.asarray([im.shape[1] for im in images], np.int32)
    dst = np.empty((len(images), out_size, out_size, c), np.uint8)
    _check(lib.retr_pad_resize_batch(_ptr(data), _ptr(offsets, _i64p), _ptr(heights, _i32p), _ptr(widths, _i32p),
                                     len(images), c, out_size, _ptr(dst), n_threads), "retr_pad_resize_batch")
    return dst


class NativeWordPiece:
    """ctypes handle on the C++ WordPiece encoder (ASCII text only: the caller
    sends anything else to the Python tokenizer)."""

    def __init__(self, vocab_path: str):
        self._lib = load("tokenizer")
        self._handle = self._lib.retr_tok_create(vocab_path.encode())
        if not self._handle:
            raise RuntimeError(f"could not read the vocabulary {vocab_path}")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.retr_tok_destroy(self._handle)
            self._handle = None

    def encode(self, text: str, max_length: int):
        """Returns (ids padded to max_length as np.int32, true length)."""
        out = np.empty(max_length, np.int32)
        n = self._lib.retr_tok_encode(self._handle, text.encode(), max_length, _ptr(out, _i32p))
        if n < 0:
            raise RuntimeError("retr_tok_encode failed")
        return out, int(n)

    def encode_batch(self, texts, max_length: int, n_threads: int = 4):
        """Returns ([N, max_length] int32 ids, [N] int32 true lengths)."""
        bufs = [t.encode() + b"\0" for t in texts]
        offsets = np.cumsum([0] + [len(b) for b in bufs[:-1]]).astype(np.int64)
        out = np.empty((len(texts), max_length), np.int32)
        lengths = np.empty(len(texts), np.int32)
        _check(self._lib.retr_tok_encode_batch(self._handle, b"".join(bufs), _ptr(offsets, _i64p), len(texts),
                                               max_length, _ptr(out, _i32p), _ptr(lengths, _i32p), n_threads),
               "retr_tok_encode_batch")
        return out, lengths
