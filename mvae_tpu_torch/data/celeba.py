"""CelebA images + 18 binary attributes (the port's copy of
mvae_tpu/data/celeba.py).

The reference's layout under the data directory: partition file
`Eval/list_eval_partition.txt`, attributes `Anno/list_attr_celeba.txt`
(-1 -> 0, cached to `Anno/attr_<partition>.npy`), 18 of 40 attributes kept
(Perarnau et al. 2016, celeba/datasets.py:32), images from
`img_align_celeba/` resized and center-cropped to 64 (celeba/train.py:
146-148) with PIL, imported when real files are read. The JAX package's
native libjpeg decode is not ported: every image takes the PIL path, which
is the reference's exact pixel semantics.

No-network fallback: a deterministic synthetic set with attribute-dependent
image structure, same shapes and dtypes, bit-identical to the JAX
package's.
"""

import os

import numpy as np

from mvae_tpu_torch.data.pipeline import ArrayDataset, warn_synthetic

VALID_PARTITIONS = {'train': 0, 'val': 1, 'test': 2}
ATTR_TO_IX_DICT = {
    'Sideburns': 30, 'Black_Hair': 8, 'Wavy_Hair': 33, 'Young': 39,
    'Heavy_Makeup': 18, 'Blond_Hair': 9, 'Attractive': 2,
    '5_o_Clock_Shadow': 0, 'Wearing_Necktie': 38, 'Blurry': 10,
    'Double_Chin': 14, 'Brown_Hair': 11, 'Mouth_Slightly_Open': 21,
    'Goatee': 16, 'Bald': 4, 'Pointy_Nose': 27, 'Gray_Hair': 17,
    'Pale_Skin': 26, 'Arched_Eyebrows': 1, 'Wearing_Hat': 35,
    'Receding_Hairline': 28, 'Straight_Hair': 32, 'Big_Nose': 7,
    'Rosy_Cheeks': 29, 'Oval_Face': 25, 'Bangs': 5, 'Male': 20,
    'Mustache': 22, 'High_Cheekbones': 19, 'No_Beard': 24, 'Eyeglasses': 15,
    'Bags_Under_Eyes': 3, 'Wearing_Necklace': 37, 'Wearing_Lipstick': 36,
    'Big_Lips': 6, 'Narrow_Eyes': 23, 'Chubby': 13, 'Smiling': 31,
    'Bushy_Eyebrows': 12, 'Wearing_Earrings': 34}
ATTR_IX_TO_KEEP = [4, 5, 8, 9, 11, 12, 15, 17, 18, 20, 21, 22, 26, 28, 31,
                   32, 33, 35]
IX_TO_ATTR_DICT = {v: k for k, v in ATTR_TO_IX_DICT.items()}
N_ATTRS = len(ATTR_IX_TO_KEEP)
ATTR_TO_PLOT = ['Heavy_Makeup', 'Male', 'Mouth_Slightly_Open', 'Smiling',
                'Wavy_Hair']


def load_eval_partition(partition, data_dir='./data'):
    out = []
    with open(os.path.join(data_dir, 'Eval/list_eval_partition.txt')) as fp:
        for row in fp:
            path, label = row.strip().split(' ')
            if int(label) == VALID_PARTITIONS[partition]:
                out.append(path)
    return out


def load_attributes(paths, partition, data_dir='./data'):
    cache = os.path.join(data_dir, 'Anno/attr_%s.npy' % partition)
    if os.path.isfile(cache):
        attr_data = np.load(cache)
    else:
        wanted = set(paths)
        attr_data = []
        with open(os.path.join(data_dir, 'Anno/list_attr_celeba.txt')) as fp:
            rows = fp.readlines()
        for row in rows[2:]:
            row = row.strip().split()
            path, attrs = row[0], row[1:]
            if path in wanted:
                a = np.array(attrs).astype(int)
                a[a < 0] = 0
                attr_data.append(a)
        attr_data = np.vstack(attr_data).astype(np.int64)
        try:
            np.save(cache, attr_data)
        except OSError:         # a read-only data directory: no cache
            pass
    return attr_data[:, ATTR_IX_TO_KEEP].astype(np.float32)


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading the real CelebA images needs Pillow (PIL), which is "
            "not installed; without the files the loader uses its "
            "synthetic set") from e
    return Image


def _resize_center_crop_64(img):
    """Resize(64) + CenterCrop(64) (celeba/train.py:146-148) via PIL."""
    Image = _pil_image()
    w, h = img.size
    scale = 64 / min(w, h)
    img = img.resize((max(64, round(w * scale)), max(64, round(h * scale))),
                     Image.BILINEAR)
    w, h = img.size
    left, top = (w - 64) // 2, (h - 64) // 2
    return img.crop((left, top, left + 64, top + 64))


def load_celeba(data_dir='./data', partition='train', *, synthetic_ok=True,
                max_examples=None, synthetic_n=None, download=False):
    """Returns ArrayDataset with image (N,64,64,3) float32 [0,1] and
    attrs (N,18) float32 {0,1}.

    download=True: CelebA has no programmatic download (the official
    distribution is interactive Google-Drive hosting; the reference also
    required a manual fetch), so it prints placement guidance and fetches
    nothing."""
    eval_file = os.path.join(data_dir, 'Eval/list_eval_partition.txt')
    if download and not os.path.isfile(eval_file):
        print("[mvae_tpu_torch] --download: CelebA is Google-Drive hosted "
              "with no stable programmatic URL (the reference required a "
              f"manual fetch too). Place under {data_dir}: Eval/"
              "list_eval_partition.txt, Anno/list_attr_celeba.txt, and "
              "img_align_celeba/*.jpg — proceeding without.")
    if os.path.isfile(eval_file):
        Image = _pil_image()
        paths = load_eval_partition(partition, data_dir)
        attrs = load_attributes(paths, partition, data_dir)
        if max_examples:
            paths, attrs = paths[:max_examples], attrs[:max_examples]
        imgs = np.empty((len(paths), 64, 64, 3), np.float32)
        for i, p in enumerate(paths):
            with Image.open(os.path.join(data_dir, 'img_align_celeba',
                                         p)) as im:
                imgs[i] = np.asarray(_resize_center_crop_64(
                    im.convert('RGB')), np.float32) / 255.0
        return ArrayDataset({"image": imgs, "attrs": attrs})
    if not synthetic_ok:
        raise FileNotFoundError(f"no CelebA metadata under {data_dir}")
    warn_synthetic(f"CelebA[{partition}]", data_dir)
    n = synthetic_n or {"train": 2000, "val": 500, "test": 500}[partition]
    return synthetic_celeba(n, seed=VALID_PARTITIONS[partition])


def synthetic_celeba(n, seed=0, size=64):
    """Attribute-driven synthetic faces-ish blobs: each attribute toggles a
    smooth spatial template so image<->attrs carry real mutual information."""
    rng = np.random.default_rng(seed + 100)
    tmpl_rng = np.random.default_rng(12345)           # shared across splits
    templates = tmpl_rng.normal(0, 1, (N_ATTRS, size, size, 3)).astype(
        np.float32)
    k = np.ones(9, np.float32) / 9.0
    for axis in (1, 2):
        templates = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, templates)
    base = tmpl_rng.normal(0.0, 0.5, (size, size, 3)).astype(np.float32)
    attrs = (rng.random((n, N_ATTRS)) < 0.3).astype(np.float32)
    imgs = base + np.tensordot(attrs, templates, axes=1) * 2.0
    imgs += rng.normal(0, 0.1, imgs.shape).astype(np.float32)
    imgs = 1.0 / (1.0 + np.exp(-imgs))
    return ArrayDataset({"image": imgs.astype(np.float32), "attrs": attrs})
