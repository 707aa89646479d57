"""The port's host-side vision pieces against the JAX package's:
``vision/transforms.py`` and ``vision/datasets.py`` (the port's own
numpy copies) and ``vision/__init__.py``.

Transforms are numpy on both sides, so outputs must be EQUAL: the
functional transforms on the same images, and the random transforms
under one ``random.seed`` (the port draws from Python's ``random`` in the
reference's order; a transform given its own ``random.Random`` draws from
that instead). ``FakeImageDataset`` yields the same images and labels
per index (``np.random.default_rng(idx)``), also through the port's
``DataLoader`` with two worker processes and shared memory, as
``examples/train_resnet.py`` reads it.
"""

import random

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
import paddle_tpu.vision.transforms as JT
import paddle_tpu_torch.vision.transforms as TT


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = T.get_device()
    T.set_device("cpu")
    yield
    T.set_device(prev)


RNG = np.random.default_rng(0)
IMG_U8 = (RNG.random((12, 10, 3)) * 255).astype(np.uint8)
IMG_F = RNG.random((12, 10, 3)).astype(np.float32)


FUNCTIONAL = [
    ("to_tensor", (IMG_U8,), {}), ("to_tensor", (IMG_F,), dict(
        data_format="HWC")),
    ("normalize", (IMG_F.transpose(2, 0, 1), [0.5] * 3, [0.2] * 3), {}),
    ("resize", (IMG_U8, 7), {}), ("resize", (IMG_F, (6, 9)), {}),
    ("resize", (IMG_U8, (5, 4)), dict(interpolation="nearest")),
    ("crop", (IMG_U8, 1, 2, 5, 4), {}), ("center_crop", (IMG_F, 6), {}),
    ("hflip", (IMG_U8,), {}), ("vflip", (IMG_F,), {}),
    ("pad", (IMG_U8, 2), {}), ("pad", (IMG_F, (1, 2, 3, 4)), dict(
        padding_mode="reflect")),
    ("adjust_brightness", (IMG_U8, 1.3), {}),
    ("adjust_contrast", (IMG_U8, 0.7), {}),
    ("adjust_saturation", (IMG_U8, 1.5), {}),
    ("adjust_hue", (IMG_U8, 0.1), {}), ("to_grayscale", (IMG_U8, 3), {}),
    ("rotate", (IMG_U8, 30.0), {}),
    ("perspective", (IMG_U8, [[0, 0], [9, 0], [9, 11], [0, 11]],
                     [[0, 1], [8, 0], [9, 10], [1, 11]]), {}),
    ("erase", (IMG_F, 1, 1, 3, 2, 0.5), {}), ("solarize", (IMG_U8,), {}),
    ("posterize", (IMG_U8, 3), {}), ("equalize", (IMG_U8,), {}),
    ("autocontrast", (IMG_U8,), {}), ("gaussian_blur", (IMG_F, 3), {}),
]


@pytest.mark.parametrize("name,args,kw", FUNCTIONAL,
                         ids=[f"{f[0]}-{i}" for i, f in enumerate(FUNCTIONAL)])
def test_functional_transforms_equal(name, args, kw):
    want = getattr(JT, name)(*args, **kw)
    got = getattr(TT, name)(*args, **kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


def _pipeline(M, **rng):
    return M.Compose([
        M.RandomResizedCrop(8, **rng), M.RandomHorizontalFlip(**rng),
        M.RandomVerticalFlip(0.3, **rng), M.RandomCrop(6, padding=1, **rng),
        M.BrightnessTransform(0.4, **rng), M.ContrastTransform(0.4, **rng),
        M.Grayscale(3), M.Pad(1), M.Resize((7, 7)), M.CenterCrop(5),
        M.Transpose(), M.Normalize(0.5, 0.25)])


def test_random_pipeline_equal_under_one_seed():
    outs = []
    for M in (JT, TT):
        random.seed(11)
        t = _pipeline(M)
        outs.append([t(IMG_U8) for _ in range(5)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


def test_own_random_source():
    """With ``rng`` a transform draws from its own ``random.Random``: the
    module's stream is untouched and the result repeats per seed."""
    random.seed(3)
    before = random.random()
    random.seed(3)
    t = _pipeline(TT, rng=random.Random(5))
    a = [t(IMG_U8) for _ in range(3)]
    assert random.random() == before
    t = _pipeline(TT, rng=random.Random(5))
    b = [t(IMG_U8) for _ in range(3)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # and the same draws as the module stream seeded alike
    random.seed(5)
    c = [_pipeline(TT)(IMG_U8) for _ in range(1)]
    np.testing.assert_array_equal(a[0], c[0])


def test_fake_image_dataset_equal_per_index():
    jd = J.vision.datasets.FakeImageDataset(6, (3, 8, 8), 10)
    td = T.vision.datasets.FakeImageDataset(6, (3, 8, 8), 10)
    assert len(td) == len(jd) == 6
    for i in range(6):
        (ja, jl), (ta, tl) = jd[i], td[i]
        np.testing.assert_array_equal(ta, ja)
        assert int(tl) == int(jl) and ta.dtype == np.float32


def test_fake_images_through_the_workers():
    """examples/train_resnet.py's loader: two forked workers with shared
    memory give the dataset's images and labels in order."""
    ds = T.vision.datasets.FakeImageDataset(8, (3, 16, 16), 100)
    loader = T.io.DataLoader(ds, batch_size=4, num_workers=2,
                             use_shared_memory=True)
    seen = 0
    for b, (x, y) in enumerate(loader):
        for j in range(4):
            img, lab = ds[4 * b + j]
            np.testing.assert_array_equal(x.numpy()[j], img)
            assert int(y.numpy()[j]) == int(lab)
        seen += 1
    assert seen == 2


def test_dataset_folder(tmp_path):
    for c in ("cat", "dog"):
        (tmp_path / c).mkdir()
        for i in range(2):
            np.save(tmp_path / c / f"{i}.npy", np.full((2, 2), i, np.float32))
    (tmp_path / "dog" / "skip.txt").write_text("x")
    jd = J.vision.datasets.ImageFolder(str(tmp_path))
    td = T.vision.datasets.ImageFolder(str(tmp_path),
                                       transform=lambda a: a + 1)
    assert td.classes == jd.classes == ["cat", "dog"]
    assert [(p, c) for p, c in td.samples] == [(p, c) for p, c in jd.samples]
    img, lab = td[3]
    np.testing.assert_array_equal(img, np.full((2, 2), 2, np.float32))
    assert int(lab) == 1
    with pytest.raises(RuntimeError, match="download"):
        T.vision.datasets.Cifar10()


def test_vision_package_surface():
    assert T.vision.get_image_backend() == J.vision.get_image_backend()
    T.vision.set_image_backend("pil")
    try:
        assert T.vision.get_image_backend() == "pil"
    finally:
        T.vision.set_image_backend("numpy")
    with pytest.raises(ValueError):
        T.vision.set_image_backend("bogus")
    with pytest.raises(NotImplementedError):
        T.vision.image_load("x.jpg")
    for n in JT.__all__:
        assert hasattr(TT, n), n
