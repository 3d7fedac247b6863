"""The port's native host ingest (mvae_tpu_torch/data/native.py over
csrc/host/*.cc) against the JAX package's (mvae_tpu/data/native.py over
its own copy of the sources), on one host: the MultiMNIST compositor and
the decode to the 64-crop bit for bit, the CelebA loader in both decode
modes, the probe and the loaders' fallbacks, `batches` (numpy's gather,
where the JAX package's is native), a build by two processes at once, and
that nothing of the port touches the JAX package's native directory.

The JAX package's library is compiled from its sources, read-only, into a
directory of the test (tests/_torch_native.py): no test runs its make. The
tests that need a compiler skip on the port's probe alone, with its
reason; the rest run everywhere.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mvae_tpu.data import celeba as jax_celeba
from mvae_tpu.data import native as jax_native
from mvae_tpu.data import pipeline as jax_pipeline
from mvae_tpu_torch.data import celeba, multimnist, native, pipeline
from mvae_tpu_torch.data.mnist import synthetic_mnist
from tests._torch_native import (
    JAX_NATIVE_DIR, ROOT, build_jax_library, makefile_flags, use_jax_library)


def needs(part):
    reason = native.unavailable_reason(part)
    if reason is not None:
        pytest.skip(f"native {part} unavailable: {reason}")


@pytest.fixture(scope="module")
def jax_so(tmp_path_factory):
    return build_jax_library(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture
def jax_lib(monkeypatch, jax_so):
    """The JAX package's native module on the test-built library; skips
    where the probe says it cannot build."""
    needs("decode")
    use_jax_library(monkeypatch, jax_so)
    return jax_native


def digit_pool(n=300, seed=0):
    imgs, labels = synthetic_mnist(n, seed=seed)
    return (imgs * 255).astype(np.uint8), labels.astype(np.int32)


def smooth_rgb(h, w, seed=0, channels=3):
    """A smooth picture with a little noise (noise alone would exaggerate
    the resampling filters' differences)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([
        128 + 100 * np.sin(x / w * 3 + c) * np.cos(y / h * 2 + c)
        for c in range(channels)], axis=-1)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pil64(path):
    with Image.open(path) as im:
        return np.asarray(celeba._resize_center_crop_64(im.convert("RGB")))


def write_celeba_tree(root: Path, images):
    """An aligned-CelebA layout of `images` (name -> PIL image), all in
    the train partition, attributes alternating."""
    for d in ("Eval", "Anno", "img_align_celeba"):
        (root / d).mkdir(parents=True, exist_ok=True)
    names = sorted(celeba.ATTR_TO_IX_DICT, key=celeba.ATTR_TO_IX_DICT.get)
    with open(root / "Eval" / "list_eval_partition.txt", "w") as f:
        f.writelines(f"{name} 0\n" for name in images)
    with open(root / "Anno" / "list_attr_celeba.txt", "w") as f:
        f.write(f"{len(images)}\n" + " ".join(names) + "\n")
        for i, name in enumerate(images):
            f.write(name + (" 1" if i % 2 else " -1") * 40 + "\n")
    for name, im in images.items():
        im.save(root / "img_align_celeba" / name, quality=95)


def tree_with_a_cmyk_jpeg(root):
    """Six 178x218 JPEGs: the third grayscale (libjpeg gives it as RGB),
    the fourth CMYK (which libjpeg will not convert to RGB: the native
    decoder refuses it)."""
    images = {f"{i:06d}.jpg": Image.fromarray(smooth_rgb(218, 178, seed=i))
              for i in range(1, 7)}
    images["000003.jpg"] = images["000003.jpg"].convert("L")
    images["000004.jpg"] = images["000004.jpg"].convert("CMYK")
    write_celeba_tree(root, images)
    return images


# --------------------------------------------------------------------------
# without a compiler: the flags, the probe, the loaders' fallbacks
# --------------------------------------------------------------------------

def test_flags_are_the_jax_makefiles():
    """The port builds with the JAX package's Makefile flags and links the
    decode part with its libraries: with equal flags on one host the two
    libraries compute alike."""
    flags, libs = makefile_flags()
    assert native.CXXFLAGS == flags
    assert native.PARTS["decode"][1] == libs
    assert native.PARTS["core"][1] == ()
    assert "-ffast-math" not in flags and "-ffp-contract=fast" not in flags


def test_probe_reports_each_part(monkeypatch, tmp_path):
    """Without a g++ on PATH both parts are unavailable and the build
    refuses with the probe's reason; a compiler whose preprocessor finds
    no jpeglib.h leaves `core` available and `decode` not; the probe runs
    that compiler once, however often it is asked."""
    monkeypatch.setenv("PATH", str(tmp_path))
    for part in ("core", "decode"):
        assert native.unavailable_reason(part) == "no g++ on PATH"
        assert not native.available(part)
        with pytest.raises(RuntimeError, match="no g.. on PATH"):
            native.build(part)
    with pytest.raises(ValueError, match="unknown native part"):
        native.unavailable_reason("gpu")
    fake = tmp_path / "g++"
    runs = tmp_path / "runs"
    fake.write_text(f"#!/bin/sh\necho run >> {runs}\n"
                    "echo \"<stdin>:2:10: fatal error: "
                    "jpeglib.h: No such file or directory\" >&2\nexit 1\n")
    fake.chmod(0o755)
    assert native.available("core")
    for _ in range(3):
        reason = native.unavailable_reason("decode")
        assert "finds no jpeglib.h or png.h" in reason
        assert "jpeglib.h: No such file or directory" in reason
        assert not native.available("decode")
    assert runs.read_text() == "run\n"


def test_loaders_announce_and_fall_back_without_a_compiler(
        monkeypatch, tmp_path, capsys):
    """With no g++ on PATH: make_dataset says so in one line and writes the
    numpy generator's shards; load_celeba says so in one line and decodes
    with PIL, the exact_decode arrays."""
    tree_with_a_cmyk_jpeg(tmp_path / "celeba")
    want = celeba.load_celeba(str(tmp_path / "celeba"), "train",
                              exact_decode=True)
    capsys.readouterr()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    got = celeba.load_celeba(str(tmp_path / "celeba"), "train")
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["[mvae_tpu_torch.data] CelebA: native decode "
                     "unavailable (no g++ on PATH); decoding with PIL"]
    for k in ("image", "attrs"):
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k])

    multimnist.make_dataset(str(tmp_path / "a"), n_train=12, n_test=5)
    out = capsys.readouterr().out
    assert out.count("native compositor unavailable (no g++ on PATH); "
                     "compositing with numpy") == 1
    multimnist.make_dataset(str(tmp_path / "b"), n_train=12, n_test=5,
                            use_native=False)
    assert "native compositor" not in capsys.readouterr().out
    for split in ("training", "test"):
        with np.load(tmp_path / "a" / "multimnist" / f"{split}.npz") as a, \
                np.load(tmp_path / "b" / "multimnist" / f"{split}.npz") as b:
            for k in ("images", "texts"):
                np.testing.assert_array_equal(a[k], b[k])


def test_missing_sources_make_the_parts_unavailable(monkeypatch, tmp_path,
                                                    capsys):
    """An installed package without csrc/host/: the probe names the
    missing source in one line whatever the host has, so available() is
    False, the build refuses with that reason, and make_dataset's default
    takes the numpy path, the shards of use_native=False."""
    empty = tmp_path / "no_sources"
    empty.mkdir()
    monkeypatch.setattr(native, "SOURCES", empty)
    for part in ("core", "decode"):
        reason = native.unavailable_reason(part)
        assert reason == f"no source {empty / native.PARTS[part][0]}"
        assert "\n" not in reason and not native.available(part)
        with pytest.raises(RuntimeError, match="no source"):
            native.build(part)
    multimnist.make_dataset(str(tmp_path / "a"), n_train=12, n_test=5,
                            use_native=None)
    out = capsys.readouterr().out
    assert out.count("native compositor unavailable (no source ") == 1
    multimnist.make_dataset(str(tmp_path / "b"), n_train=12, n_test=5,
                            use_native=False)
    for split in ("training", "test"):
        with np.load(tmp_path / "a" / "multimnist" / f"{split}.npz") as a, \
                np.load(tmp_path / "b" / "multimnist" / f"{split}.npz") as b:
            for k in ("images", "texts"):
                np.testing.assert_array_equal(a[k], b[k])
    monkeypatch.undo()
    assert native.unavailable_reason("core") != \
        f"no source {empty / 'mvae_native.cc'}"


def test_package_data_ships_the_host_sources():
    """pyproject.toml's package data for mvae_tpu_torch names the host
    library's C++ sources beside the CUDA ones, and the pattern matches
    both of them."""
    import tomllib
    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = conf["tool"]["setuptools"]["package-data"]["mvae_tpu_torch"]
    assert "csrc/host/*.cc" in data and "csrc/*.cu" in data
    pkg = ROOT / "mvae_tpu_torch"
    shipped = {p.name for pat in data for p in pkg.glob(pat)}
    assert {src for src, _ in native.PARTS.values()} <= shipped


def test_batches_are_the_jax_packages(monkeypatch):
    """batches, numpy's fancy indexing with no native gather, yields the
    JAX package's batches (its gather on numpy here: its native one would
    run its make) for every array and dtype, shuffled and in order, and
    builds no library."""
    monkeypatch.setattr(native, "library", lambda part: 1 / 0)
    monkeypatch.setattr(jax_pipeline, "_gather_fn",
                        lambda: (lambda v, take: v[take]))
    rng = np.random.default_rng(3)
    arrays = {"image": rng.integers(0, 256, (23, 4, 4, 3), dtype=np.uint8),
              "attrs": rng.random((23, 18), dtype=np.float32),
              "text": rng.integers(0, 10, (23, 4), dtype=np.int32)}
    for shuffle in (True, False):
        got = list(pipeline.batches(pipeline.ArrayDataset(arrays), 5,
                                    shuffle=shuffle, seed=2, epoch=1))
        want = list(jax_pipeline.batches(jax_pipeline.ArrayDataset(arrays),
                                         5, shuffle=shuffle, seed=2,
                                         epoch=1))
        assert len(got) == len(want) == (4 if shuffle else 5)
        for g, w in zip(got, want):
            for k in arrays:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


_AUDIT = r"""
import json, os, sys
from pathlib import Path
watched, work = os.path.realpath(sys.argv[1]), Path(sys.argv[2])
hits, seen = [], []

def under(p):
    try:
        p = os.path.realpath(os.fsdecode(p))
    except (TypeError, ValueError):
        return False
    return p == watched or p.startswith(watched + os.sep)

def hook(event, args):
    if event == "open":
        paths = args[:1]
    elif event in ("os.rename", "os.replace", "os.remove", "os.mkdir",
                   "os.rmdir", "os.chmod", "os.utime", "os.truncate",
                   "shutil.rmtree", "ctypes.dlopen"):
        paths = args[:2] if event in ("os.rename", "os.replace") else args[:1]
    elif event == "subprocess.Popen":
        paths = [args[0], args[2]] + list(args[1])
        seen.append(event)
    else:
        return
    if event == "open" and str(work) in str(args[0]):
        seen.append(event)
    if event == "ctypes.dlopen":
        seen.append(event)
    for p in paths:
        if isinstance(p, (str, bytes, os.PathLike)) and under(p):
            hits.append([event, os.fsdecode(p)])
sys.addaudithook(hook)

from mvae_tpu_torch.data import celeba, multimnist, native, pipeline
native.BUILD_DIR = work / "build"
multimnist.make_dataset(str(work / "mm"), n_train=20, n_test=5)
ds = celeba.load_celeba(str(work / "celeba"), "train")
list(pipeline.batches(ds, 2, shuffle=True))
print(json.dumps({"hits": hits, "seen": sorted(set(seen))}))
"""


def test_jax_native_directory_is_left_alone(tmp_path):
    """The port's loaders, with a fresh build of its libraries, run in a
    process whose every open, rename, removal, dlopen and subprocess is
    audited: none names the JAX package's native directory. Its entries
    and their modification times are the same before and after (but the
    library the JAX package's own make writes there, which its tests in
    other workers may build meanwhile: the audit covers it)."""
    def listing():
        return {e.name: e.stat().st_mtime_ns for e in os.scandir(
            JAX_NATIVE_DIR) if e.name != "libmvae_native.so"}
    tree_with_a_cmyk_jpeg(tmp_path / "celeba")
    before = listing()
    assert {"Makefile", "mvae_native.cc", "image_decode.cc"} <= set(before)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _AUDIT, str(JAX_NATIVE_DIR),
                          str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["hits"] == []
    assert "open" in out["seen"]            # the hook saw the loaders work
    if native.available("core"):
        assert {"subprocess.Popen", "ctypes.dlopen"} <= set(out["seen"])
    assert listing() == before


# --------------------------------------------------------------------------
# with a compiler: the port against the JAX package's library
# --------------------------------------------------------------------------

COMPOSITOR_OPTIONS = [
    {}, {"min_digits": 2, "max_digits": 3}, {"resize": False},
    {"min_digits": 0, "max_digits": 1, "translate": False}]


def test_compositor_is_jax_bit_for_bit(jax_lib):
    """multimnist_generate from one digit pool, for each option set and
    two seeds: images and strings equal to the JAX package's native
    compositor; a pool of all-255 digits centred at k = 2 finds no
    composition on either side."""
    digits, labels = digit_pool()
    for opts in COMPOSITOR_OPTIONS:
        for seed in (681307, 5):
            got = native.multimnist_generate(digits, labels, 200, seed=seed,
                                             **opts)
            want = jax_lib.multimnist_generate(digits, labels, 200,
                                               seed=seed, **opts)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w, err_msg=str(opts))
            counts = (got[1] != 11).sum(1)
            lo, hi = opts.get("min_digits", 0), opts.get("max_digits", 4)
            assert set(np.unique(counts)) == set(range(lo, hi + 1))
    full = np.full((10, 28, 28), 255, np.uint8)
    for gen in (native.multimnist_generate, jax_lib.multimnist_generate):
        with pytest.raises(RuntimeError, match="3/3 canvases"):
            gen(full, labels[:10], 3, min_digits=2, max_digits=2,
                translate=False)
    with pytest.raises(ValueError, match="min_digits <= max_digits <= 4"):
        native.multimnist_generate(digits, labels, 3, max_digits=5)


def test_decode_is_jax_bit_for_bit_and_near_pil(jax_lib, tmp_path):
    """decode_image_64 equals the JAX package's byte for byte on JPEGs at
    CelebA's 178x218, landscape, exactly 64x64 and below 64 (an upscale),
    and on RGBA, palette and 16-bit PNGs; within 4/255 mean of PIL; a
    missing or corrupt file raises ValueError on both sides."""
    rgb = smooth_rgb(218, 178)
    cases = {
        "celeba.jpg": Image.fromarray(rgb),
        "landscape.jpg": Image.fromarray(smooth_rgb(150, 260, seed=1)),
        "exact.jpg": Image.fromarray(smooth_rgb(64, 64, seed=2)),
        "small.jpg": Image.fromarray(smooth_rgb(40, 50, seed=3)),
        "rgba.png": Image.fromarray(smooth_rgb(218, 178, seed=4,
                                               channels=4)),
        "palette.png": Image.fromarray(rgb).quantize(64),
    }
    gray = smooth_rgb(120, 100, seed=5)[..., 0]
    for name, im in cases.items():
        im.save(tmp_path / name, quality=95)
    Image.fromarray(gray).save(tmp_path / "gray8.png")
    # 16-bit: the 8-bit picture in the high byte (PIL decodes the 8-bit one)
    Image.fromarray(gray.astype(np.uint16) * 257).save(tmp_path / "16.png")
    assert Image.open(tmp_path / "16.png").mode.startswith("I")
    assert Image.open(tmp_path / "palette.png").mode == "P"
    for name in list(cases) + ["16.png"]:
        path = str(tmp_path / name)
        got = native.decode_image_64(path)
        assert got.shape == (64, 64, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_lib.decode_image_64(path),
                                      err_msg=name)
        pil = pil64(tmp_path / ("gray8.png" if name == "16.png" else name))
        gap = np.abs(got.astype(int) - pil.astype(int)).mean()
        assert gap < 4.0, (name, gap)
    (tmp_path / "corrupt.jpg").write_bytes(b"not a jpeg at all")
    (tmp_path / "corrupt.png").write_bytes(b"\x89PNG\r\n\x1a\n broken")
    for name, rc in (("missing.jpg", 1), ("corrupt.jpg", 2),
                     ("corrupt.png", 2)):
        for decode in (native.decode_image_64, jax_lib.decode_image_64):
            with pytest.raises(ValueError, match=f"failed \\({rc}\\)"):
                decode(str(tmp_path / name))


def test_load_celeba_is_jax_in_both_modes(jax_lib, tmp_path, capsys):
    """load_celeba on a small JPEG tree with a CMYK JPEG fourth: the native
    default and exact_decode equal the JAX package's loader in the same
    mode bit for bit; at the CMYK file both switch to PIL for the rest of
    the set (one line says so), so rows 4-6 are PIL's, and rows 1-3 (a
    grayscale JPEG among them) the native decoder's."""
    tree_with_a_cmyk_jpeg(tmp_path)
    got = {exact: celeba.load_celeba(str(tmp_path), "train",
                                     exact_decode=exact)
           for exact in (False, True)}
    out = capsys.readouterr().out
    assert out.count("decoding this and the remaining 2 images with PIL") \
        == 1 and "000004.jpg" in out and "native decode failed (2)" in out
    for exact, ds in got.items():
        want = jax_celeba.load_celeba(str(tmp_path), "train",
                                      exact_decode=exact)
        for k in ("image", "attrs"):
            assert ds.arrays[k].dtype == want.arrays[k].dtype
            np.testing.assert_array_equal(ds.arrays[k], want.arrays[k])
    native_img, pil_img = got[False].arrays["image"], got[True].arrays["image"]
    np.testing.assert_array_equal(native_img[3:], pil_img[3:])
    assert all((native_img[i] != pil_img[i]).any() for i in range(3))
    assert np.abs(native_img[:3] - pil_img[:3]).mean() < 4 / 255


def test_two_processes_build_at_once(tmp_path):
    """Two processes that find no library build it at once, each into its
    own temporary file renamed into place: both load a whole library and
    composite with it alike, one library is left, no temporary file."""
    needs("core")
    code = (
        "import sys\nfrom pathlib import Path\nimport numpy as np\n"
        "from mvae_tpu_torch.data import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "native.library('core')\n"
        "digits = np.arange(20 * 784).reshape(20, 28, 28) % 256\n"
        "img, txt = native.multimnist_generate(\n"
        "    digits, np.arange(20) % 10, 50, max_digits=1)\n"
        "print(native.library_path('core').name, img.sum(), txt.sum())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1
    assert [f.name for f in tmp_path.iterdir() if f.suffix == ".so"] \
        == [lines.pop().split()[0]]
    assert not [f for f in tmp_path.iterdir() if f.is_dir()]
