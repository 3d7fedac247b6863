"""The port's MNIST / FashionMNIST downloader (mvae_tpu_torch/data/
download.py) and its `--download` wiring, all offline: every URL is a
`file://` URL over IDX archives the test writes with data/mnist.py:
write_idx, fetched by the real `_fetch` (urllib reads file:// URLs), so
nothing opens a network connection."""

import hashlib
import os

import numpy as np
import pytest

import mvae_tpu_torch.data.download as dl
from mvae_tpu.data.download import URL_TABLES as JAX_URL_TABLES
from mvae_tpu_torch.data.mnist import load_mnist, write_idx
from mvae_tpu_torch.data.multimnist import load_multimnist

NAMES = ["train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
         "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"]


def test_url_tables_are_the_jax_packages():
    assert dl.URL_TABLES == JAX_URL_TABLES
    for variant in ("MNIST", "FashionMNIST"):
        assert sorted(dl.URL_TABLES[variant]) == sorted(NAMES)


def _md5(path):
    return hashlib.md5(path.read_bytes()).hexdigest()


def mirror(tmp_path, n=12):
    """Gzipped IDX archives of n train and n // 2 test rows under
    tmp_path/mirror, and a URL table of file:// URLs with their MD5s;
    returns (table, {name: array})."""
    rng = np.random.default_rng(0)
    arrays = {NAMES[0]: rng.integers(0, 256, (n, 28, 28), dtype=np.uint8),
              NAMES[1]: rng.integers(0, 10, (n,), dtype=np.uint8),
              NAMES[2]: rng.integers(0, 256, (n // 2, 28, 28),
                                     dtype=np.uint8),
              NAMES[3]: rng.integers(0, 10, (n // 2,), dtype=np.uint8)}
    d = tmp_path / "mirror"
    d.mkdir()
    table = {}
    for name, a in arrays.items():
        write_idx(str(d / name), a)
        table[name] = (_md5(d / name), [(d / name).as_uri()])
    return table, arrays


@pytest.fixture
def fetches(monkeypatch):
    """Every URL the real _fetch is given, which must be a file:// URL."""
    seen = []
    real = dl._fetch

    def fetch(url, dst, timeout=60.0):
        assert url.startswith("file://"), url
        seen.append(url)
        return real(url, dst, timeout)

    monkeypatch.setattr(dl, "_fetch", fetch)
    return seen


@pytest.mark.parametrize("variant", ["MNIST", "FashionMNIST"])
def test_download_places_and_verifies(tmp_path, monkeypatch, fetches,
                                      variant):
    """The four archives land under <root>/<variant>/raw with their MD5s,
    and load_mnist reads them; a second call keeps the verified files and
    fetches nothing."""
    table, arrays = mirror(tmp_path)
    monkeypatch.setitem(dl.URL_TABLES, variant, table)
    root = tmp_path / "data"
    raw = dl.download_idx(str(root), variant, verbose=False)
    assert raw == os.path.join(str(root), variant, "raw")
    assert sorted(os.listdir(raw)) == sorted(NAMES)
    for name, (md5, _) in table.items():
        assert dl._md5(os.path.join(raw, name)) == md5
    assert len(fetches) == 4
    ds = load_mnist(str(root), train=True, variant=variant,
                    synthetic_ok=False)
    np.testing.assert_array_equal(
        ds.arrays["image"],
        arrays[NAMES[0]].reshape(-1, 784).astype(np.float32) / 255.0)
    np.testing.assert_array_equal(ds.arrays["text"], arrays[NAMES[1]])
    dl.download_idx(str(root), variant, verbose=False)
    assert len(fetches) == 4


def test_a_right_file_is_kept_and_a_wrong_one_fetched(tmp_path, monkeypatch,
                                                      fetches):
    table, _ = mirror(tmp_path)
    monkeypatch.setitem(dl.URL_TABLES, "MNIST", table)
    raw = tmp_path / "data" / "MNIST" / "raw"
    raw.mkdir(parents=True)
    for name in NAMES[:2]:
        (raw / name).write_bytes((tmp_path / "mirror" / name).read_bytes())
    (raw / NAMES[2]).write_bytes(b"stale")
    dl.download_idx(str(tmp_path / "data"), "MNIST", verbose=False)
    assert [u.rsplit("/", 1)[1] for u in fetches] == NAMES[2:]
    assert dl._md5(str(raw / NAMES[2])) == table[NAMES[2]][0]


def test_wrong_md5_tries_the_next_url_then_raises(tmp_path, monkeypatch,
                                                  fetches):
    table, _ = mirror(tmp_path)
    name = NAMES[0]
    md5, (good,) = table[name]
    bad = tmp_path / "bad.gz"
    bad.write_bytes(b"not the archive")
    table[name] = (md5, [bad.as_uri(), good])
    monkeypatch.setitem(dl.URL_TABLES, "MNIST", table)
    raw = dl.download_idx(str(tmp_path / "data"), "MNIST", verbose=False)
    assert dl._md5(os.path.join(raw, name)) == md5
    assert fetches[:2] == [bad.as_uri(), good]
    table[name] = (md5, [bad.as_uri()])
    os.unlink(os.path.join(raw, name))
    with pytest.raises(dl.DownloadError, match=name) as e:
        dl.download_idx(str(tmp_path / "data"), "MNIST", verbose=False)
    assert f"md5 {_md5(bad)} != {md5}" in str(e.value)
    assert f"Place the file manually under {raw}" in str(e.value)
    assert not os.path.exists(os.path.join(raw, name))


def test_a_failed_fetch_leaves_no_part_file(tmp_path, monkeypatch, fetches):
    table, _ = mirror(tmp_path)
    missing = (tmp_path / "mirror" / "missing.gz").as_uri()
    table[NAMES[1]] = (table[NAMES[1]][0], [missing])
    monkeypatch.setitem(dl.URL_TABLES, "MNIST", table)
    with pytest.raises(dl.DownloadError, match=NAMES[1]):
        dl.download_idx(str(tmp_path / "data"), "MNIST", verbose=False)
    raw = tmp_path / "data" / "MNIST" / "raw"
    assert sorted(os.listdir(raw)) == [NAMES[0]]
    assert fetches == [table[NAMES[0]][1][0], missing]


def _unreachable(monkeypatch, tmp_path, variant):
    table = {name: ("0" * 32, [(tmp_path / "none" / name).as_uri()])
             for name in NAMES}
    monkeypatch.setitem(dl.URL_TABLES, variant, table)


@pytest.mark.parametrize("variant", ["MNIST", "FashionMNIST"])
def test_download_flag_without_a_reachable_url_falls_back(
        tmp_path, monkeypatch, capsys, fetches, variant):
    """load_mnist(download=True) with no URL that answers: the message,
    then the synthetic set."""
    _unreachable(monkeypatch, tmp_path, variant)
    ds = load_mnist(str(tmp_path), train=False, variant=variant,
                    download=True)
    out = capsys.readouterr().out
    assert "--download failed (could not fetch" in out
    assert "synthetic fallback" in out
    assert ds.arrays["image"].shape == (10000, 784)
    assert len(fetches) == 1


def test_multimnist_download_fetches_the_source_digits(tmp_path,
                                                       monkeypatch, capsys,
                                                       fetches):
    """load_multimnist(download=True) without shards fetches the MNIST
    archives first; with no URL that answers it says so and goes on to
    generate the shards (stubbed here); with shards present it fetches
    nothing."""
    _unreachable(monkeypatch, tmp_path, "MNIST")
    monkeypatch.setattr(
        "mvae_tpu_torch.data.multimnist.make_dataset",
        lambda root, n_train, n_test: _write_shards(root, n_train, n_test))
    ds = load_multimnist(str(tmp_path), train=False, generate_n=10,
                         download=True)
    assert "--download failed (could not fetch" in capsys.readouterr().out
    assert ds.arrays["image"].shape == (200, 50, 50, 1)
    assert len(fetches) == 1
    load_multimnist(str(tmp_path), train=False, download=True)
    assert len(fetches) == 1


def _write_shards(root, n_train, n_test):
    d = os.path.join(root, "multimnist")
    os.makedirs(d, exist_ok=True)
    for split, n in (("training", n_train), ("test", n_test)):
        np.savez_compressed(os.path.join(d, f"{split}.npz"),
                            images=np.zeros((n, 50, 50), np.uint8),
                            texts=np.zeros((n, 4), np.int32))
