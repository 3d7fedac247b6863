"""The JAX package's native library for the port's tests: compiled from its
sources, read-only, with its Makefile's flags into a directory the test
owns, and handed to `mvae_tpu.data.native` by monkeypatching its `_SO`,
`_build` and `_lib`. The tests never run `make -C native`, which writes
into that directory and races with the JAX package's own tests in other
workers."""

import re
import subprocess
from pathlib import Path

from mvae_tpu.data import native as jax_native
from mvae_tpu_torch.data import native

ROOT = Path(__file__).resolve().parents[1]
JAX_NATIVE_DIR = ROOT / "native"


def makefile_flags():
    """(CXXFLAGS, link libraries) of the JAX package's Makefile."""
    text = (JAX_NATIVE_DIR / "Makefile").read_text()
    flags = re.search(r"^CXXFLAGS \?= (.+)$", text, re.M).group(1).split()
    libs = re.search(r"\$\^ (.+)$", text, re.M).group(1).split()
    return tuple(flags), tuple(libs)


def jax_library_reason():
    """None where the JAX package's one library (both sources, linked with
    libjpeg and libpng) can build here: the port's `decode` probe."""
    return native.unavailable_reason("decode")


def build_jax_library(out_dir: Path):
    """The JAX package's library built into out_dir; None where the probe
    says it cannot build (the JAX package then takes its numpy and PIL
    paths, as on a host where its make fails)."""
    if jax_library_reason() is not None:
        return None
    flags, libs = makefile_flags()
    so = out_dir / "libmvae_native_jax.so"
    subprocess.run(["g++", *flags, "-o", str(so),
                    str(JAX_NATIVE_DIR / "mvae_native.cc"),
                    str(JAX_NATIVE_DIR / "image_decode.cc"), *libs],
                   check=True, capture_output=True, timeout=600)
    return so


def use_jax_library(monkeypatch, so):
    """Point the JAX package's loader at `so` (None: at no library, so that
    its `available()` is False) for one test."""
    missing = ROOT / "build" / "no-such-library.so"
    monkeypatch.setattr(jax_native, "_SO", str(so or missing))
    monkeypatch.setattr(jax_native, "_build", lambda: None)
    monkeypatch.setattr(jax_native, "_lib", None)
