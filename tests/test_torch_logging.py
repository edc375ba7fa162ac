"""The port's logging container and the entry points' logging flags on the
CPU.

* ``ScalarWriter``'s ``scalars.tsv`` (where the tensorboard package does
  not import) line for line the reference's; with tensorboard, an event
  file; ``make_logdir``'s layout; ``TableLogger`` and ``Timer``;
* ``--eval_before_start`` on both entry points: the validation pass runs
  and the trajectory stays bitwise what it is without the flag;
* ``--tensorboard`` writes its scalars under ``runs/``; ``--profile DIR``
  writes a Chrome trace there.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from commefficient_tpu.utils import logging as jax_logging
from commefficient_tpu_torch.training import cv, gpt2
from commefficient_tpu_torch.training.args import build_parser
from commefficient_tpu_torch.utils import logging as port_logging


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tests' tensors are small: one intra-op thread keeps each
    operation from waiting on threads that the suite's other workers
    hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_tensorboard(monkeypatch):
    """Make ``from torch.utils.tensorboard import SummaryWriter`` fail."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_scalar_writer_tsv_matches_the_reference(tmp_path, monkeypatch):
    _no_tensorboard(monkeypatch)
    scalars = [("train_loss", 2.5, 1), ("test_acc", np.float32(0.125), 1),
               ("lr", 0.4, 2), ("nll", np.float64(3.25), 0)]
    for mod, side in ((port_logging, "port"), (jax_logging, "ref")):
        w = mod.ScalarWriter(str(tmp_path / side))
        for tag, value, step in scalars:
            w.add_scalar(tag, value, step)
        w.close()
    port = (tmp_path / "port" / "scalars.tsv").read_text()
    assert port == (tmp_path / "ref" / "scalars.tsv").read_text()
    assert port.splitlines()[0] == "1\ttrain_loss\t2.5"


def test_scalar_writer_uses_tensorboard_where_it_imports(tmp_path,
                                                         monkeypatch):
    made = []

    class Writer:
        def __init__(self, log_dir):
            made.append(log_dir)
            self.scalars = []

        def add_scalar(self, *a):
            self.scalars.append(a)

        def flush(self):
            pass

        def close(self):
            pass

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    w = port_logging.ScalarWriter(str(tmp_path / "tb"))
    w.add_scalar("lr", 0.1, 3)
    assert made == [str(tmp_path / "tb")] and w._tb.scalars == [
        ("lr", 0.1, 3)]
    w.close()
    assert not (tmp_path / "tb" / "scalars.tsv").exists()


def test_make_logdir_layout():
    cfg = types.SimpleNamespace(num_workers=8, num_clients=100, mode="sketch")
    got = port_logging.make_logdir(cfg).split(os.sep)
    ref = jax_logging.make_logdir(cfg).split(os.sep)
    assert got[0] == ref[0] == "runs"
    assert got[1].endswith("_8") and got[2] == ref[2] == "100_sketch"
    assert len(got) == len(ref) == 3


def test_table_logger_and_timer(capsys):
    table = port_logging.TableLogger()
    table.append({"epoch": 1, "loss": 0.5})
    table.append({"epoch": 2, "loss": 0.25})
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["epoch", "loss"]
    assert lines[2].split() == ["2", "0.2500"]
    timer = port_logging.Timer()
    a, b = timer(), timer(include_in_total=False)
    assert a >= 0 and b >= 0 and timer.total_time == a
    tsv = port_logging.TSVLogger()
    tsv.append({"epoch": 1, "total_time": 3600.0, "test_acc": 0.5})
    assert str(tsv).splitlines()[1] == "1\t1.00000000\t50.00"


def _cv_args(tmp_path, *extra):
    (tmp_path / "stats.json").write_text(json.dumps(
        {"images_per_client": [8] * 10, "num_val_images": 16}))
    return build_parser().parse_args([
        "--model", "TinyMLP", "--mode", "sketch", "--error_type", "virtual",
        "--virtual_momentum", "0.9", "--num_workers", "4",
        "--local_batch_size", "8", "--k", "100", "--num_rows", "3",
        "--num_cols", "1000", "--valid_batch_size", "16", "--num_epochs",
        "1", "--dataset_dir", str(tmp_path), "--device", "cpu", *extra])


def _gpt2_args(tmp_path, *extra):
    return gpt2.build_gpt2_parser().parse_args([
        "--device", "cpu", "--model", "gpt2-tiny", "--max_seq_len", "32",
        "--attn_impl", "blockwise", "--mode", "sketch", "--k", "1000",
        "--num_cols", "5000", "--num_rows", "3", "--num_epochs", "1",
        "--synthetic_personas", "4", "--synthetic_dialogs", "2",
        "--dataset_dir", str(tmp_path / "persona"), *extra])


def test_eval_before_start_leaves_the_trajectory(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    base, row = cv.train(_cv_args(tmp_path), log=False)
    with_eval, row_e = cv.train(_cv_args(tmp_path, "--eval_before_start"))
    assert "eval before start: loss=" in capsys.readouterr().out
    assert torch.equal(base.state.weights, with_eval.state.weights)
    assert [r["loss"] for r in row["rounds"]] == [
        r["loss"] for r in row_e["rounds"]]
    # GPT2: dropout draws its seeds from the learner's generator
    base, row = gpt2.train(_gpt2_args(tmp_path), max_rounds=2, log=False)
    with_eval, row_e = gpt2.train(_gpt2_args(tmp_path, "--eval_before_start"),
                                  max_rounds=2)
    assert "eval before start: nll=" in capsys.readouterr().out
    assert torch.equal(base.state.weights, with_eval.state.weights)
    assert [r["loss"] for r in row["rounds"]] == [
        r["loss"] for r in row_e["rounds"]]


def test_tensorboard_and_profile_flags(tmp_path, monkeypatch):
    _no_tensorboard(monkeypatch)
    monkeypatch.chdir(tmp_path)
    trace_dir = tmp_path / "trace"
    argv = ["--model", "TinyMLP", "--mode", "uncompressed", "--num_workers",
            "4", "--local_batch_size", "8", "--valid_batch_size", "16",
            "--num_epochs", "1", "--dataset_dir", str(tmp_path), "--device",
            "cpu", "--tensorboard", "--eval_before_start", "--profile",
            str(trace_dir)]
    _cv_args(tmp_path)   # writes the small stats.json
    assert cv.main(argv) == 0
    trace = json.loads((trace_dir / port_logging.TRACE_FILE).read_text())
    assert trace["traceEvents"]
    tsv, = (tmp_path / "runs").glob("*/*/scalars.tsv")
    lines = [line.split("\t") for line in tsv.read_text().splitlines()]
    assert [(s, t) for s, t, _ in lines] == [
        ("0", "test_loss"), ("0", "test_acc")] + [
        ("1", t) for t in ("train_loss", "train_acc", "train_time",
                           "test_loss", "test_acc", "test_time", "lr")]
    # the GPT2 entry point takes the same flags
    gpt2_trace = tmp_path / "trace_gpt2"
    assert gpt2.main(["--device", "cpu", "--model", "gpt2-tiny",
                      "--max_seq_len", "32", "--mode", "uncompressed",
                      "--num_epochs", "1", "--synthetic_personas", "4",
                      "--synthetic_dialogs", "2", "--dataset_dir",
                      str(tmp_path / "persona"), "--tensorboard",
                      "--profile", str(gpt2_trace), "--test"]) == 0
    assert (gpt2_trace / port_logging.TRACE_FILE).exists()
    tags = {line.split("\t")[1] for p in (tmp_path / "runs").glob(
        "*/*/scalars.tsv") for line in p.read_text().splitlines()}
    assert {"nll", "ppl", "mc_acc"} <= tags


def test_profile_ctx_null_without_a_dir():
    with port_logging.profile_ctx(None) as prof:
        assert prof is None
    with port_logging.profile_ctx("") as prof:
        assert prof is None


@pytest.mark.parametrize("flag,dest,default", [
    ("--eval_before_start", "eval_before_start", False),
    ("--tensorboard", "use_tensorboard", False),
    ("--profile", "profile", None)])
def test_flags_parse_as_the_references(flag, dest, default):
    from commefficient_tpu.training.args import build_parser as jax_parser
    port, ref = build_parser().parse_args([]), jax_parser().parse_args([])
    assert getattr(port, dest) == getattr(ref, dest) == default
    extra = [flag, "d"] if flag == "--profile" else [flag]
    port = build_parser().parse_args(extra)
    ref = jax_parser().parse_args(extra)
    assert getattr(port, dest) == getattr(ref, dest)
