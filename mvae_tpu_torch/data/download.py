"""Dataset downloader: the MNIST and FashionMNIST IDX archives (the
port's copy of mvae_tpu/data/download.py).

The reference's train CLIs let torchvision download MNIST once
(mnist/train.py:159-165); FashionMNIST only swaps the URL table
(fashionmnist/datasets.py:8-29). `download_idx` fetches the four .gz
archives into `<root>/<variant>/raw`, where data/mnist.py reads them,
checks each file's MD5, and raises DownloadError with a message that
says where to place the files by hand when no URL answers (a host with
no egress): the callers print it and go on with the files they have or
the synthetic set.

URLs: FashionMNIST's are the reference's table
(fashionmnist/datasets.py:24-29); MNIST's are torchvision's mirror and
the original yann.lecun.com URLs. The MD5s are torchvision's published
values for these archives.
"""

import hashlib
import os
import tempfile

_FASHION_BASE = "http://fashion-mnist.s3-website.eu-central-1.amazonaws.com"

# filename -> (md5, [urls])  — first URL that answers wins
URL_TABLES = {
    "MNIST": {
        "train-images-idx3-ubyte.gz": (
            "f68b3c2dcbeaaa9fbdd348bbdeb94873",
            ["https://ossci-datasets.s3.amazonaws.com/mnist/"
             "train-images-idx3-ubyte.gz",
             "http://yann.lecun.com/exdb/mnist/train-images-idx3-ubyte.gz"]),
        "train-labels-idx1-ubyte.gz": (
            "d53e105ee54ea40749a09fcbcd1e9432",
            ["https://ossci-datasets.s3.amazonaws.com/mnist/"
             "train-labels-idx1-ubyte.gz",
             "http://yann.lecun.com/exdb/mnist/train-labels-idx1-ubyte.gz"]),
        "t10k-images-idx3-ubyte.gz": (
            "9fb629c4189551a2d022fa330f9573f3",
            ["https://ossci-datasets.s3.amazonaws.com/mnist/"
             "t10k-images-idx3-ubyte.gz",
             "http://yann.lecun.com/exdb/mnist/t10k-images-idx3-ubyte.gz"]),
        "t10k-labels-idx1-ubyte.gz": (
            "ec29112dd5afa0611ce80d1b7f02629c",
            ["https://ossci-datasets.s3.amazonaws.com/mnist/"
             "t10k-labels-idx1-ubyte.gz",
             "http://yann.lecun.com/exdb/mnist/t10k-labels-idx1-ubyte.gz"]),
    },
    "FashionMNIST": {
        "train-images-idx3-ubyte.gz": (
            "8d4fb7e6c68d591d4c3dfef9ec88bf0d",
            [f"{_FASHION_BASE}/train-images-idx3-ubyte.gz"]),
        "train-labels-idx1-ubyte.gz": (
            "25c81989df183df01b3e8a0aad5dffbe",
            [f"{_FASHION_BASE}/train-labels-idx1-ubyte.gz"]),
        "t10k-images-idx3-ubyte.gz": (
            "bef4ecab320f06d8554ea6380940ec79",
            [f"{_FASHION_BASE}/t10k-images-idx3-ubyte.gz"]),
        "t10k-labels-idx1-ubyte.gz": (
            "bb300cfdad3c16e7a12a480ee83cd310",
            [f"{_FASHION_BASE}/t10k-labels-idx1-ubyte.gz"]),
    },
}


class DownloadError(RuntimeError):
    pass


def _md5(path, chunk=1 << 20):
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def _fetch(url, dst, timeout=60.0):
    """Stream `url` to `dst` atomically (temp file + rename)."""
    import urllib.request
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dst) or ".",
                               suffix=".part")
    try:
        with os.fdopen(fd, "wb") as out, \
                urllib.request.urlopen(url, timeout=timeout) as resp:
            while True:
                b = resp.read(1 << 20)
                if not b:
                    break
                out.write(b)
        os.replace(tmp, dst)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def download_idx(root="./data", variant="MNIST", *, fetch=None,
                 verbose=True):
    """Ensure the four IDX .gz archives exist (checksum-verified) under
    `<root>/<variant>/raw`. Already-present verified files are kept
    (torchvision's download-once contract). Raises DownloadError with a
    remediation message if any fetch fails — callers treat that as
    "no egress" and fall through to their existing file/synthetic paths.

    `fetch` is injectable for offline tests of the placement/verify logic.
    """
    if fetch is None:
        fetch = _fetch          # resolved at call time (test-injectable)
    table = URL_TABLES[variant]
    raw = os.path.join(root, variant, "raw")
    os.makedirs(raw, exist_ok=True)
    for fname, (md5, urls) in table.items():
        dst = os.path.join(raw, fname)
        if os.path.exists(dst) and _md5(dst) == md5:
            continue
        errs = []
        for url in urls:
            try:
                if verbose:
                    print(f"Downloading {url}")
                fetch(url, dst)
            except Exception as e:            # noqa: BLE001 — report & next
                errs.append(f"{url}: {e}")
                continue
            got = _md5(dst)
            if got == md5:
                break
            errs.append(f"{url}: md5 {got} != {md5}")
            os.unlink(dst)
        else:
            raise DownloadError(
                f"could not fetch {fname} for {variant}: "
                + "; ".join(errs)
                + f". Place the file manually under {raw} "
                  "(gz or extracted) — the loader reads both.")
    return raw
