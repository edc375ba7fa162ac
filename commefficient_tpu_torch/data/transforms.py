"""Host-side augmentation pipelines (numpy copy of
``commefficient_tpu/data/transforms.py``, same stages, constants and draw
order).

Images flow as NHWC arrays. Each transform is ``fn(cols, rng) -> cols``
over the batch's column list (the first column is the image batch), so
pipelines compose with plain function composition.

``fused_pad_crop_train`` and ``fused_rrc_train`` run the geometric
stages as one threaded C++ pass (``commefficient_tpu_torch.native``),
as the reference's do: the random draws stay here, in the numpy stages'
order from the same ``RandomState`` (per image ``y`` then ``x``, or the
crop window's draws; then one ``rand(B)`` for the batch's flips), so the
pad-crop batches are bitwise the numpy stages' and RandomResizedCrop's
agree to float rounding (2e-4). A batch whose shape or dtype the C++
pass does not take goes to the numpy stages, which fail loudly on a
mismatch; so does every batch under ``COMMEFFICIENT_NO_NATIVE=1``.
"""

from __future__ import annotations

import numpy as np

from commefficient_tpu_torch import native

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2471, 0.2435, 0.2616], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4867, 0.4408], np.float32)
CIFAR100_STD = np.array([0.2675, 0.2565, 0.2761], np.float32)
FEMNIST_MEAN = np.array([0.9637], np.float32)
FEMNIST_STD = np.array([0.1597], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(mean, std):
    def fn(cols, rng):
        was_uint8 = cols[0].dtype == np.uint8
        img = cols[0].astype(np.float32)
        if was_uint8:
            img = img / 255.0
        cols[0] = (img - mean) / std
        return cols
    return fn


def random_crop(size: int, padding: int, mode: str = "reflect",
                fill: float = 0.0):
    def fn(cols, rng):
        img = cols[0]
        pad = ((0, 0), (padding, padding), (padding, padding), (0, 0))
        if mode == "reflect":
            padded = np.pad(img, pad, mode="reflect")
        else:
            padded = np.pad(img, pad, mode="constant", constant_values=fill)
        out = np.empty_like(img)
        for i in range(img.shape[0]):
            y = rng.randint(0, 2 * padding + 1)
            x = rng.randint(0, 2 * padding + 1)
            out[i] = padded[i, y:y + size, x:x + size]
        cols[0] = out
        return cols
    return fn


def random_hflip(p: float = 0.5):
    def fn(cols, rng):
        img = cols[0]
        flips = rng.rand(img.shape[0]) < p
        img = img.copy()
        img[flips] = img[flips, :, ::-1]
        cols[0] = img
        return cols
    return fn


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of one HWC image (any dtype -> float32), half-pixel
    centres, edges clamped."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.astype(np.float32)
    y = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    x = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(y - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    wx = np.clip(x - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def rrc_crop_params(h, w, rng, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """One RandomResizedCrop window (torchvision's semantics): 10
    area/aspect attempts, then the centre fallback."""
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = rng.randint(0, h - ch + 1)
            left = rng.randint(0, w - cw + 1)
            return top, left, ch, cw
    # fallback: the largest centre crop within the ratio bounds
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def random_resized_crop(size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """Sample a crop window per image (``rrc_crop_params``) and resize it
    to ``size`` x ``size``."""

    def fn(cols, rng):
        img = cols[0]
        was_uint8 = img.dtype == np.uint8
        B, h, w = img.shape[:3]
        out = np.empty((B, size, size, img.shape[3]), np.float32)
        for i in range(B):
            top, left, ch, cw = rrc_crop_params(h, w, rng, scale, ratio)
            out[i] = _bilinear_resize(img[i, top:top + ch, left:left + cw],
                                      size, size)
        cols[0] = out / 255.0 if was_uint8 else out
        return cols
    return fn


def resize_center_crop(size: int, resize_to: int):
    """Resize the shorter side to ``resize_to``, then centre-crop
    ``size``."""

    def fn(cols, rng):
        img = cols[0]
        was_uint8 = img.dtype == np.uint8
        B, h, w = img.shape[:3]
        s = resize_to / min(h, w)
        rh, rw = max(resize_to, round(h * s)), max(resize_to, round(w * s))
        top, left = (rh - size) // 2, (rw - size) // 2
        out = np.empty((B, size, size, img.shape[3]), np.float32)
        for i in range(B):
            r = (_bilinear_resize(img[i], rh, rw)
                 if (rh, rw) != (h, w) else img[i].astype(np.float32))
            out[i] = r[top:top + size, left:left + size]
        cols[0] = out / 255.0 if was_uint8 else out
        return cols
    return fn


def compose(*fns):
    def fn(cols, rng):
        for f in fns:
            cols = f(list(cols), rng)
        return cols
    return fn


def fused_rrc_train(mean, std, size: int, hflip_p: float = 0.5,
                    scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """RandomResizedCrop, horizontal flip, normalize: one native pass over
    a uint8 batch of ``len(mean)`` channels (the crop windows and flips
    drawn here first), the numpy stages otherwise."""
    numpy_fn = compose(random_resized_crop(size, scale, ratio),
                       random_hflip(hflip_p), normalize(mean, std))
    # the affine on raw uint8: (v / 255 - mean) / std == v * kscale + kbias
    kscale = (1.0 / (255.0 * std)).astype(np.float32)
    kbias = (-mean / std).astype(np.float32)

    def fn(cols, rng):
        img = cols[0]
        if (native.lib() is None or img.dtype != np.uint8
                or img.shape[3] != len(kscale)):
            return numpy_fn(cols, rng)
        B, h, w = img.shape[:3]
        params = np.empty((B, 5), np.int32)
        for i in range(B):
            params[i, :4] = rrc_crop_params(h, w, rng, scale, ratio)
        params[:, 4] = rng.rand(B) < hflip_p
        cols[0] = native.rrc_batch(img, params, size, kscale, kbias)
        return cols
    return fn


def fused_pad_crop_train(mean, std, size: int, padding: int,
                         mode: str = "reflect", fill: float = 0.0,
                         hflip_p: float = 0.5):
    """Normalize, then pad-and-crop and (for ``hflip_p > 0``) flip as one
    native pass of copies, bitwise the numpy stages. Normalize runs first,
    so a constant ``fill`` lands in the output as it is, in normalized
    units. The pass takes ``size == H == W`` only (as the numpy stage,
    which writes into ``empty_like(img)``); any other batch goes to the
    numpy stages."""
    aug = ([random_crop(size, padding, mode, fill)]
           + ([random_hflip(hflip_p)] if hflip_p > 0 else []))
    numpy_fn = compose(normalize(mean, std), *aug)
    norm_fn = normalize(mean, std)

    def fn(cols, rng):
        img = cols[0]
        if (native.lib() is None or img.shape[1] != size
                or img.shape[2] != size):
            return numpy_fn(cols, rng)
        cols = norm_fn(cols, rng)
        B = cols[0].shape[0]
        params = np.empty((B, 3), np.int32)
        for i in range(B):
            params[i, 0] = rng.randint(0, 2 * padding + 1)
            params[i, 1] = rng.randint(0, 2 * padding + 1)
        params[:, 2] = (rng.rand(B) < hflip_p) if hflip_p > 0 else 0
        cols[0] = native.pad_crop_batch(cols[0], params, padding,
                                        mode == "reflect", fill)
        return cols
    return fn


cifar10_train_transforms = fused_pad_crop_train(
    CIFAR10_MEAN, CIFAR10_STD, 32, 4, "reflect")
cifar10_test_transforms = normalize(CIFAR10_MEAN, CIFAR10_STD)
cifar100_train_transforms = fused_pad_crop_train(
    CIFAR100_MEAN, CIFAR100_STD, 32, 4, "reflect")
cifar100_test_transforms = normalize(CIFAR100_MEAN, CIFAR100_STD)
femnist_train_transforms = fused_pad_crop_train(
    FEMNIST_MEAN, FEMNIST_STD, 28, 2, "constant", fill=1.0, hflip_p=0.0)
femnist_test_transforms = normalize(FEMNIST_MEAN, FEMNIST_STD)
# stored uint8 at 256 -> RandomResizedCrop(224) + flip (train) /
# resize(256) + centre crop(224) (validation) -> normalize
imagenet_train_transforms = fused_rrc_train(
    IMAGENET_MEAN, IMAGENET_STD, 224)
imagenet_val_transforms = compose(
    resize_center_crop(224, resize_to=256),
    normalize(IMAGENET_MEAN, IMAGENET_STD))


def get_transforms(dataset_name: str, train: bool):
    table = {
        "CIFAR10": (cifar10_train_transforms, cifar10_test_transforms),
        "CIFAR100": (cifar100_train_transforms, cifar100_test_transforms),
        "EMNIST": (femnist_train_transforms, femnist_test_transforms),
        "ImageNet": (imagenet_train_transforms, imagenet_val_transforms),
        "Synthetic": (None, None),
    }
    tr, te = table.get(dataset_name, (None, None))
    return tr if train else te
