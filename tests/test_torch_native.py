"""The port's C++ host data plane (``commefficient_tpu_torch/native``)
against the JAX package's (``commefficient_tpu.native``) and against the
numpy stages, on the CPU:

* ``gather_rows`` (an array and a ``np.memmap``) and ``pad_crop_batch``
  (CIFAR's reflect pad 4 with flips, EMNIST's constant fill 1.0 in
  normalized units without) bitwise; ``rrc_batch`` within the
  reference's 2e-4, the ``RandomState`` left in the same state;
* the bounds guard, two threads calling at once;
* the library built under ``commefficient_tpu_torch/_build/``, a compiler
  failure raising (no silent fallback), ``COMMEFFICIENT_NO_NATIVE=1``
  the one way to the numpy stages;
* ``get_transforms`` for CIFAR10, EMNIST and ImageNet reaching the native
  call, and ImageNet's memory-mapped gather.
"""

import threading

import numpy as np
import pytest

from commefficient_tpu import native as ref_native
from commefficient_tpu.data import transforms as RT
from commefficient_tpu_torch import native
from commefficient_tpu_torch.data import transforms as T
from commefficient_tpu_torch.data.imagenet import FedImageNet

pytestmark = pytest.mark.skipif(ref_native.lib() is None,
                                reason="the reference's native library "
                                       "did not build")


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv(native.OPT_OUT, raising=False)


def _calls():
    return dict(native.CALLS)


def _delta(before):
    return {k: v - before.get(k, 0) for k, v in native.CALLS.items()
            if v - before.get(k, 0)}


def test_library_builds_under_the_ports_build_dir():
    h = native.lib()
    assert h is native.lib() and h.fedio_abi_version() == native.ABI
    so = native.lib_path()
    assert so.parent == native.BUILD_DIR and so.exists()
    assert so.parent.name == "_build"
    assert so.parent.parent.name == "commefficient_tpu_torch"


@pytest.mark.parametrize("memmap", [False, True], ids=["array", "memmap"])
def test_gather_rows_bitwise(memmap, tmp_path):
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (64, 17, 3), np.uint8)
    if memmap:
        np.save(tmp_path / "rows.npy", src)
        src = np.load(tmp_path / "rows.npy", mmap_mode="r")
    idx = rng.randint(0, 64, 40)
    before = _calls()
    got = native.gather_rows(src, idx)
    assert _delta(before) == {"gather_rows": 1}
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, ref_native.gather_rows(src, idx))
    fsrc = rng.randn(32, 5).astype(np.float32)
    np.testing.assert_array_equal(native.gather_rows(fsrc, idx % 32),
                                  fsrc[idx % 32])


def test_gather_rows_bounds_guard():
    src = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert native.gather_rows(src, np.array([], np.int64)).shape == (0, 3)
    for bad in ([4], [-1]):
        with pytest.raises(IndexError):
            native.gather_rows(src, np.array(bad, np.int64))


# CIFAR10's train transform (reflect pad 4, flips) and EMNIST's (constant
# fill 1.0 in normalized units, pad 2, no flip), at their image shapes
PAD_CROP = {
    "cifar": ((16, 32, 32, 3), T.CIFAR10_MEAN, T.CIFAR10_STD, 32, 4,
              "reflect", 0.0, 0.5),
    "emnist": ((16, 28, 28, 1), T.FEMNIST_MEAN, T.FEMNIST_STD, 28, 2,
               "constant", 1.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(PAD_CROP))
def test_pad_crop_bitwise_reference_and_numpy(case):
    shape, mean, std, size, pad, mode, fill, p = PAD_CROP[case]
    imgs = np.random.RandomState(2).randint(0, 256, shape, np.uint8)
    aug = [T.random_crop(size, pad, mode, fill)] + (
        [T.random_hflip(p)] if p > 0 else [])
    numpy_fn = T.compose(T.normalize(mean, std), *aug)
    rngs = [np.random.RandomState(9) for _ in range(3)]
    before = _calls()
    got = T.fused_pad_crop_train(mean, std, size, pad, mode, fill, p)(
        [imgs], rngs[0])[0]
    assert _delta(before) == {"pad_crop_batch": 1}
    want = numpy_fn([imgs], rngs[1])[0]
    ref = RT.fused_pad_crop_train(mean, std, size, pad, mode, fill, p)(
        [imgs], rngs[2])[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    states = [r.get_state()[1:] for r in rngs]
    for s in states[1:]:
        assert states[0][1] == s[1]
        np.testing.assert_array_equal(states[0][0], s[0])
    if mode == "constant":
        assert np.any(got == np.float32(fill))   # the fill in the border


def test_rrc_within_2e4_and_same_draws():
    imgs = np.random.RandomState(1).randint(0, 256, (6, 64, 48, 3),
                                            np.uint8)
    mean, std = T.IMAGENET_MEAN, T.IMAGENET_STD
    numpy_fn = T.compose(T.random_resized_crop(32), T.random_hflip(),
                         T.normalize(mean, std))
    rngs = [np.random.RandomState(7) for _ in range(3)]
    before = _calls()
    got = T.fused_rrc_train(mean, std, 32)([imgs], rngs[0])[0]
    assert _delta(before) == {"rrc_batch": 1}
    want = numpy_fn([imgs], rngs[1])[0]
    ref = RT.fused_rrc_train(mean, std, 32)([imgs], rngs[2])[0]
    assert got.shape == want.shape == (6, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=2e-4)
    # the two C++ copies do the same arithmetic
    np.testing.assert_array_equal(got, ref)
    draws = [r.randint(1 << 30, size=4) for r in rngs]
    np.testing.assert_array_equal(draws[0], draws[1])
    np.testing.assert_array_equal(draws[0], draws[2])


def test_shape_guards_send_a_batch_to_the_numpy_stages():
    before = _calls()
    # a float batch: RRC's native pass takes uint8 only
    imgs = np.random.RandomState(0).rand(2, 40, 40, 3).astype(np.float32)
    out = T.fused_rrc_train(T.IMAGENET_MEAN, T.IMAGENET_STD, 16)(
        [imgs], np.random.RandomState(0))[0]
    assert out.shape == (2, 16, 16, 3)
    # a size that is not the image's: the numpy stage fails loudly
    imgs = np.zeros((2, 30, 30, 3), np.uint8)
    with pytest.raises(ValueError):
        T.fused_pad_crop_train(T.CIFAR10_MEAN, T.CIFAR10_STD, 32, 4)(
            [imgs], np.random.RandomState(0))
    assert _delta(before) == {}


def test_two_threads_calling_at_once():
    rng = np.random.RandomState(0)
    src = rng.randint(0, 255, (512, 33), np.uint8)
    imgs = rng.randint(0, 256, (8, 32, 32, 3), np.uint8)
    fn = T.cifar10_train_transforms
    want = fn([imgs], np.random.RandomState(5))[0]
    errs = []

    def worker(seed):
        r = np.random.RandomState(seed)
        for _ in range(40):
            idx = r.randint(0, 512, 257)
            if not np.array_equal(native.gather_rows(src, idx), src[idx]):
                errs.append("gather")
            if not np.array_equal(fn([imgs], np.random.RandomState(5))[0],
                                  want):
                errs.append("pad_crop")

    threads = [threading.Thread(target=worker, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errs


def test_compiler_failure_raises_and_the_opt_out(monkeypatch, tmp_path):
    bad = tmp_path / "fedio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed") as info:
        native.lib()
    assert "error" in str(info.value)
    assert not list((tmp_path / "_build").glob("*.so"))
    imgs = np.random.RandomState(0).randint(0, 256, (4, 32, 32, 3),
                                            np.uint8)
    with pytest.raises(RuntimeError):
        T.cifar10_train_transforms([imgs], np.random.RandomState(0))
    # COMMEFFICIENT_NO_NATIVE=1: no build, the numpy stages, no call
    monkeypatch.setenv(native.OPT_OUT, "1")
    assert native.lib() is None
    before = _calls()
    out = T.cifar10_train_transforms([imgs], np.random.RandomState(0))[0]
    assert _delta(before) == {}
    monkeypatch.undo()
    np.testing.assert_array_equal(
        out, T.cifar10_train_transforms([imgs], np.random.RandomState(0))[0])


@pytest.mark.parametrize("name,shape,call", [
    ("CIFAR10", (4, 32, 32, 3), "pad_crop_batch"),
    ("CIFAR100", (4, 32, 32, 3), "pad_crop_batch"),
    ("EMNIST", (4, 28, 28, 1), "pad_crop_batch"),
    ("ImageNet", (2, 64, 64, 3), "rrc_batch")])
def test_get_transforms_reaches_the_native_call(name, shape, call):
    imgs = np.random.RandomState(0).randint(0, 256, shape, np.uint8)
    before = _calls()
    out = T.get_transforms(name, True)([imgs, np.zeros(shape[0])],
                                       np.random.RandomState(0))
    assert _delta(before) == {call: 1}
    assert out[0].dtype == np.float32


def test_imagenet_gather_is_native_on_a_memmap(tmp_path):
    rng = np.random.RandomState(3)
    rows = rng.randint(0, 256, (20, 8, 8, 3), np.uint8)
    np.save(tmp_path / "c.npy", rows)
    arr = np.load(tmp_path / "c.npy", mmap_mode="r")
    idxs = rng.permutation(20)[:7]
    before = _calls()
    got = FedImageNet._gather(arr, idxs)
    assert _delta(before) == {"gather_rows": 1}
    np.testing.assert_array_equal(got, rows[idxs])
