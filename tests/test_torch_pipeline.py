"""The entry points' pipelined loop on the CPU, within the port.

* ``RoundPipeline``: each push returns the previous round's metrics, the
  flush the last one's, each equal to ``train_round``'s;
* ``device_prefetch``: order and values kept at every lookahead size,
  the client ids and the mask left host numpy arrays;
* the CV loop (prefetch, lookahead, pipeline) against a blocking loop of
  ``train_round`` calls over the same batches: per-round metrics and
  weights bitwise;
* the offload path under the pipelined loop: a gather-ahead hit for every
  round but the first, every round's rows written back at the epoch's
  end.
"""

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.data import FedBatcher
from commefficient_tpu_torch.data.prefetch import (device_prefetch,
                                                   with_lookahead)
from commefficient_tpu_torch.federated.api import FedLearner, RoundPipeline
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.models.toy import TinyMLP
from commefficient_tpu_torch.training import cv
from commefficient_tpu_torch.training.args import build_parser

W, B = 3, 4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tests' tensors are small: one intra-op thread keeps each
    operation from waiting on threads that the suite's other workers
    hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _learner():
    model = TinyMLP(num_classes=2, hidden=16, in_channels=8, image_size=1)
    model.reset_parameters(torch.Generator().manual_seed(0))
    cfg = FedConfig(mode="true_topk", error_type="virtual",
                    virtual_momentum=0.9, k=20, num_workers=W, num_clients=6,
                    lr_scale=0.05)
    return FedLearner(model, cfg, make_cv_loss(model), device="cpu")


def _rounds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.choice(6, W, replace=False).astype(np.int32),
             (rng.randn(W, B, 8).astype(np.float32),
              rng.randint(0, 2, (W, B)).astype(np.int32)),
             np.ones((W, B), np.float32)) for _ in range(n)]


def test_round_pipeline_lags_one_round_and_flushes():
    a, b = _learner(), _learner()
    rounds = _rounds(3)
    want = [a.train_round(*r) for r in rounds]
    pipe = b.pipeline()
    assert isinstance(pipe, RoundPipeline)
    got = [pipe.push(b.train_round_async(*r)) for r in rounds]
    assert got[0] is None
    got = got[1:] + [pipe.flush()]
    assert pipe.flush() is None
    for x, y in zip(want, got):
        assert x["loss"] == y["loss"]
        assert x["upload_bytes"] == y["upload_bytes"]
        np.testing.assert_array_equal(x["metrics"], y["metrics"])
    assert torch.equal(a.state.weights, b.state.weights)
    assert a.total_upload_bytes == b.total_upload_bytes


@pytest.mark.parametrize("size", [1, 2, 99])
def test_device_prefetch_keeps_order_values_and_host_ids_mask(size):
    items = [(np.full((2,), i, np.int32),
              (np.full((3, 2), i * 10.0, np.float32),
               np.full((3,), i, np.int64)),
              np.full((3,), i % 2, np.float32)) for i in range(5)]
    out = list(device_prefetch(iter(items), size=size, device="cpu"))
    assert len(out) == 5
    for i, (ids, cols, mask) in enumerate(out):
        assert isinstance(ids, np.ndarray)
        np.testing.assert_array_equal(ids, items[i][0])
        for c, ref in zip(cols, items[i][1]):
            assert isinstance(c, torch.Tensor) and c.dtype == torch.as_tensor(
                ref).dtype
            np.testing.assert_array_equal(c.numpy(), ref)
        assert isinstance(mask, np.ndarray)
        np.testing.assert_array_equal(mask, items[i][2])
    with pytest.raises(ValueError, match="prefetch size"):
        list(device_prefetch(iter(items), size=0, device="cpu"))


def _cli_args(tmp_path, *extra):
    (tmp_path / "stats.json").write_text(
        '{"images_per_client": [16, 16, 16, 16, 16, 16, 16, 16, 16, 16], '
        '"num_val_images": 32}')
    return build_parser().parse_args([
        "--model", "TinyMLP", "--mode", "local_topk", "--error_type",
        "local", "--local_momentum", "0.9", "--num_workers", "4",
        "--local_batch_size", "8", "--k", "200", "--valid_batch_size", "32",
        "--num_epochs", "1", "--dataset_dir", str(tmp_path), "--device",
        "cpu", *extra])


def test_pipelined_cv_loop_equals_the_blocking_loop(tmp_path):
    args = _cli_args(tmp_path)
    learner, row = cv.train(args, log=False)
    # the blocking loop over the same batches: the probe draw, then
    # train_round after train_round
    args = _cli_args(tmp_path)
    train_set = cv.make_dataset(args, train=True)
    args.num_clients = train_set.num_clients
    batcher = FedBatcher(train_set, args.num_workers, args.local_batch_size,
                         seed=args.seed)
    _, probe_cols, _ = next(iter(batcher.epoch()))
    ref = cv.build_learner(args, 10, 3, "cpu",
                           image_size=probe_cols[0].shape[2])
    spe = batcher.steps_per_epoch()
    outs = [ref.train_round(ids, cols, mask, epoch_frac=t / spe)
            for t, (ids, cols, mask) in enumerate(batcher.epoch())]
    assert len(outs) == len(row["rounds"]) == 5
    for x, y in zip(outs, row["rounds"]):
        assert (x["loss"], x["upload_bytes"], x["download_bytes"]) == (
            y["loss"], y["upload_bytes"], y["download_bytes"])
        assert y["round_s"] >= 0
    assert torch.equal(ref.state.weights, learner.state.weights)
    assert torch.equal(ref.state.clients.errors, learner.state.clients.errors)
    assert row["feed_batches"] >= 5 and row["feed_s"] > 0


def test_offload_gather_ahead_under_the_pipelined_loop(tmp_path):
    args = _cli_args(tmp_path, "--client_state_offload")
    learner, row = cv.train(args, log=False)
    stats = learner._offload_pipe.stats
    assert len(row["rounds"]) == 5
    assert stats["gathers"] == 5 and stats["prefetch_hits"] == 4
    assert stats["flushed_rounds"] == 5
    assert not learner._offload_pipe._pending
    dense, _ = cv.train(_cli_args(tmp_path), log=False)
    assert torch.equal(dense.state.weights, learner.state.weights)
    assert torch.equal(dense.state.clients.errors[:-1],
                       learner.host_store.arena("errors"))


def test_with_lookahead_pairs_each_item_with_the_next():
    assert list(with_lookahead(iter([1, 2, 3]))) == [(1, 2), (2, 3),
                                                      (3, None)]
    assert list(with_lookahead(iter([]))) == []
