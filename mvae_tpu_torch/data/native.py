"""The port's native host ingest: ctypes bindings over its own C++ sources
in `csrc/host/` (the counterpart of mvae_tpu/data/native.py), with the
JAX functions' signatures and errors.

Two libraries, each built with g++ at first use, from the sources in the
checkout only, into `build/mvae_tpu_torch/` at the repository root:

  core    `mvae_native.cc`: the MultiMNIST compositor; no dependencies
  decode  `image_decode.cc`: the libjpeg / libpng decode to the 64-crop;
          linked with -ljpeg -lpng -lz

A library's name carries a hash of its source, the flags and what
-march=native means to the compiler on this host, so an edited source, a
new compiler or another CPU builds anew. The build writes a temporary file
and renames it into place: processes that build at once each load a whole
library. Within a process one lock guards the first load.

Whether a part is available is a probe, never a caught build error: the
part's source in `csrc/host/` (an installed package may lack it), a g++
on PATH, and for `decode` also jpeglib.h and png.h found by that
compiler's preprocessor (a host without the image headers keeps the
compositor). The probe runs once a process for each part, source and
compiler.
Where the probe passes and the build fails, the call raises with the
compiler's log. The callers (data/celeba.py, data/multimnist.py) take
their PIL or numpy path where a part is unavailable, and say so.

The JAX module's `gather_rows` has no counterpart: numpy's fancy indexing
gathers the port's batches (data/pipeline.py).
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SOURCES = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mvae_tpu_torch"
# the JAX package's Makefile flags: with equal flags on one host the port's
# output equals the JAX package's bit for bit
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
PARTS = {"core": ("mvae_native.cc", ()),
         "decode": ("image_decode.cc", ("-ljpeg", "-lpng", "-lz"))}
ABI = 4             # mvae_native_abi_version() of mvae_native.cc
# what the decode probe preprocesses: the headers image_decode.cc includes
_DECODE_PROBE = "#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n"

_LOCK = threading.Lock()
_LIBS = {}


def _compiler():
    return shutil.which("g++")


def unavailable_reason(part: str):
    """None where `part` can be built here, else why not (one line)."""
    if part not in PARTS:
        raise ValueError(f"unknown native part {part!r}: one of "
                         f"{list(PARTS)}")
    return _probe(part, SOURCES / PARTS[part][0], _compiler())


@functools.cache
def _probe(part: str, source: Path, gxx):
    if not source.is_file():
        return f"no source {source}"
    if gxx is None:
        return "no g++ on PATH"
    if part == "decode":
        res = subprocess.run([gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                             input=_DECODE_PROBE, capture_output=True,
                             text=True, timeout=60)
        if res.returncode != 0:
            err = res.stderr.strip().splitlines() or [
                f"preprocessor exit {res.returncode}"]
            return f"{gxx} finds no jpeglib.h or png.h: {err[0]}"
    return None


def available(part: str) -> bool:
    return unavailable_reason(part) is None


@functools.cache
def _target(gxx: str) -> bytes:
    """The compiler's version and what -march=native resolves to here."""
    version = subprocess.run([gxx, "--version"], capture_output=True,
                             timeout=60).stdout
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, timeout=60).stdout
    return version + target


def library_path(part: str) -> Path:
    """Where `part`'s library of this source, these flags and this host's
    compiler lives (the probe must have passed)."""
    source, libs = PARTS[part]
    h = hashlib.sha256(" ".join(CXXFLAGS + libs).encode())
    h.update(_target(_compiler()))
    h.update(source.encode())
    h.update((SOURCES / source).read_bytes())
    return BUILD_DIR / f"libmvae_host_{part}-{h.hexdigest()[:16]}.so"


def build(part: str) -> Path:
    """Compile `part` unless a library of the same source, flags and
    target exists; returns its path. The compiler's log lands beside it."""
    reason = unavailable_reason(part)
    if reason is not None:
        raise RuntimeError(f"native {part} library unavailable: {reason}")
    gxx = _compiler()
    so = library_path(part)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source, libs = PARTS[part]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, so.name)
        cmd = [gxx, *CXXFLAGS, "-o", out, str(SOURCES / source), *libs]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"native {part} build failed "
                               f"({res.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(out, so)
    so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
    return so


def library(part: str):
    """The loaded library of `part`, built on first use. `build_seconds` is
    the wall time of the first call, the build included."""
    with _LOCK:
        if part not in _LIBS:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build(part)))
            _declare(part, lib)
            lib.build_seconds = time.perf_counter() - t0
            _LIBS[part] = lib
        return _LIBS[part]


def _declare(part, lib):
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    if part == "decode":
        for f in (lib.decode_jpeg_64, lib.decode_png_64):
            f.argtypes = [ctypes.c_char_p, p]
            f.restype = ctypes.c_int
        return
    lib.mvae_native_abi_version.argtypes = []
    lib.mvae_native_abi_version.restype = ctypes.c_int
    abi = lib.mvae_native_abi_version()
    if abi != ABI:
        raise RuntimeError(f"native core library ABI {abi}, expected {ABI}")
    lib.multimnist_generate.argtypes = [
        p, p, i64, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, p, p]
    lib.multimnist_generate.restype = i64


def multimnist_generate(digits: np.ndarray, labels: np.ndarray, n_out: int,
                        *, min_digits=0, max_digits=4, resize=True,
                        translate=True, seed=681307):
    """digits: (N, 28, 28) uint8; labels: (N,) int32.
    Returns (images (n_out, 50, 50) uint8, texts (n_out, 4) int32).
    Raises RuntimeError where a canvas found no composition within the
    retry budget (a pool too dense for k digits)."""
    digits = np.ascontiguousarray(digits, np.uint8)
    labels = np.ascontiguousarray(labels, np.int32)
    if digits.ndim != 3 or digits.shape[1:] != (28, 28):
        raise ValueError(f"digits must be (N, 28, 28), got {digits.shape}")
    if labels.shape != (len(digits),):
        raise ValueError(f"labels must be ({len(digits)},), got "
                         f"{labels.shape}")
    if not 0 <= min_digits <= max_digits <= 4:
        raise ValueError(f"need 0 <= min_digits <= max_digits <= 4, got "
                         f"{min_digits}, {max_digits}")
    if max_digits > 0 and len(digits) == 0:
        raise ValueError("an empty digit pool")
    lib = library("core")
    images = np.empty((n_out, 50, 50), np.uint8)
    texts = np.empty((n_out, 4), np.int32)
    n_failed = lib.multimnist_generate(
        digits.ctypes.data, labels.ctypes.data,
        len(digits), n_out, min_digits, max_digits,
        int(resize), int(translate), seed,
        images.ctypes.data, texts.ctypes.data)
    if n_failed:
        raise RuntimeError(
            f"multimnist: {n_failed}/{n_out} canvases found no "
            "non-overlapping composition (digit pool too dense?)")
    return images, texts


def decode_image_64(path) -> np.ndarray:
    """A JPEG or PNG file -> (64, 64, 3) uint8 with the CelebA
    preprocessing (Resize(64) + CenterCrop(64)): libjpeg's DCT-domain
    prescale, box halvings and a bilinear resample (libpng for a .png).
    Its pixels differ from PIL's antialiased BILINEAR by a few levels;
    ValueError carries the decoder's return code (1 the file would not
    open, 2 libjpeg or libpng refused it, as libjpeg refuses a CMYK JPEG,
    3 a JPEG that libjpeg did not give as 3 channels)."""
    lib = library("decode")
    path = str(path)
    out = np.empty((64, 64, 3), np.uint8)
    fn = (lib.decode_png_64 if path.lower().endswith(".png")
          else lib.decode_jpeg_64)
    rc = fn(os.fsencode(path), out.ctypes.data)
    if rc != 0:
        raise ValueError(f"native decode failed ({rc}): {path}")
    return out

