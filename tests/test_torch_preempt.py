"""The port's preemption contract on the CPU: a run killed at any point and
restarted with ``--resume auto`` ends bitwise where the uninterrupted run
ends (the final export's state arrays, host rows, byte totals, round
count and the learner's generator).

* a child process SIGKILLed once its first step checkpoint exists;
* a child SIGKILLed inside its second save, between the temp file's
  fsync and the rename (``COMMEFF_CRASH_POINT ckpt_before_replace``): the
  previous checkpoint stays and the resume falls back to it;
* SIGTERM: the guard finishes the round, saves and returns (exit 0);
* the buffered server's event cursor through a resume, in process;
* ``--finetune`` from the export: the head alone moves;
* a tripped guard ends the run with no checkpoint written.

The children import torch and the port only; every run keeps one torch
thread, so a child and the test process reduce alike. Each resume runs in
this process.
"""

import os
import shutil
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.training import cv
from commefficient_tpu_torch.training.args import build_parser
from commefficient_tpu_torch.training.loop import RoundFeed
from commefficient_tpu_torch.training.preempt import PreemptionGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from commefficient_tpu_torch.training.cv import main
    sys.exit(main(sys.argv[1:]))
""")

#: Digits with TinyMLP, 75 rounds in 0.8 of an epoch: a child outlives its
#: first step file by over 60 rounds
_BASE = ["--model", "TinyMLP", "--dataset_name", "Digits",
         "--num_workers", "2", "--local_batch_size", "8",
         "--valid_batch_size", "128", "--lr_scale", "0.01",
         "--num_epochs", "0.8", "--seed", "3", "--device", "cpu",
         "--mode", "local_topk", "--error_type", "local", "--k", "5"]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def digits(tmp_path_factory):
    """The Digits cache, built once, shared by every run."""
    d = str(tmp_path_factory.mktemp("digits"))
    cv.make_dataset(build_parser().parse_args(
        _BASE + ["--dataset_dir", d]), train=True)
    return d


def argv(digits, ckpt, *extra):
    return _BASE + ["--dataset_dir", digits, "--checkpoint",
                    "--checkpoint_path", str(ckpt), *extra]


@pytest.fixture(scope="module")
def baseline(tmp_path_factory, digits):
    """The uninterrupted run's export directory."""
    ckpt = tmp_path_factory.mktemp("base") / "ckpt"
    assert cv.main(argv(digits, ckpt)) == 0
    return ckpt


def _child(workdir, args, env_extra=None):
    script = os.path.join(str(workdir), "child.py")
    with open(script, "w") as f:
        f.write(CHILD)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("COMMEFF_CRASH_POINT", None)
    env.pop("COMMEFF_CRASH_AT_SAVE", None)
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, script] + args, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _assert_final_bitwise(dir_a, dir_b, name="TinyMLP"):
    with np.load(os.path.join(str(dir_a), f"{name}.npz")) as a, \
            np.load(os.path.join(str(dir_b), f"{name}.npz")) as b:
        keys = [k for k in a.files if k.startswith(("arr_", "host_"))]
        assert keys and sorted(keys) == sorted(
            k for k in b.files if k.startswith(("arr_", "host_")))
        for k in keys + ["rounds_done", "total_download_bytes",
                         "total_upload_bytes", "torch_generator"]:
            np.testing.assert_array_equal(
                a[k], b[k], err_msg=f"final checkpoint key {k!r} differs "
                f"between the uninterrupted and the resumed run")


def _resume(digits, ckpt, capsys, *extra):
    capsys.readouterr()
    assert cv.main(argv(digits, ckpt, "--checkpoint_every_rounds", "10",
                        "--resume", "auto", *extra)) == 0
    return capsys.readouterr().out


def test_sigkill_mid_training_resumes_bitwise(tmp_path, digits, baseline,
                                             capsys):
    ckpt = tmp_path / "ckpt"
    p = _child(tmp_path, argv(digits, ckpt, "--checkpoint_every_rounds",
                              "10"))
    deadline = time.time() + 120
    try:
        while time.time() < deadline:
            if p.poll() is not None:
                raise AssertionError(f"child exited (rc={p.returncode}) "
                                     f"before the kill:\n{p.stdout.read()}")
            if ckpt.is_dir() and any("_r" in f and f.endswith(".npz")
                                     for f in os.listdir(ckpt)):
                p.send_signal(signal.SIGKILL)
                break
            time.sleep(0.01)
        out, _ = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == -signal.SIGKILL, out
    assert not (ckpt / "TinyMLP.npz").exists()
    out = _resume(digits, ckpt, capsys)
    assert "resumed from" in out, out
    _assert_final_bitwise(baseline, ckpt)


def test_sigkill_between_fsync_and_rename_keeps_previous(
        tmp_path, digits, baseline, capsys):
    ckpt = tmp_path / "ckpt"
    p = _child(tmp_path, argv(digits, ckpt, "--checkpoint_every_rounds",
                              "10"),
               {"COMMEFF_CRASH_POINT": "ckpt_before_replace",
                "COMMEFF_CRASH_AT_SAVE": "2"})
    out, _ = p.communicate(timeout=120)
    assert p.returncode == -signal.SIGKILL, out
    files = os.listdir(ckpt)
    # the second save died before its rename: its temp file is the trace
    assert any(f.endswith(".tmp") for f in files), files
    assert "TinyMLP_r00000010.npz" in files, files
    assert "TinyMLP_r00000020.npz" not in files, files
    out = _resume(digits, ckpt, capsys)
    assert "TinyMLP_r00000010.npz" in out, out
    _assert_final_bitwise(baseline, ckpt)


def test_sigterm_finishes_round_saves_and_exits(tmp_path, digits, baseline,
                                               capsys, monkeypatch):
    """SIGTERM lands while round 13 is dispatched: the round finishes, its
    metrics are read, round 13's checkpoint is written and ``main``
    returns 0."""
    ckpt = tmp_path / "ckpt"
    push = RoundFeed.push
    calls = []

    def push_then_signal(self, *a, **k):
        out = push(self, *a, **k)
        calls.append(1)
        if len(calls) == 13:
            # only ever into the guard: the default action would end the
            # test process
            handler = signal.getsignal(signal.SIGTERM)
            assert isinstance(getattr(handler, "__self__", None),
                              PreemptionGuard), handler
            signal.raise_signal(signal.SIGTERM)
        return out
    monkeypatch.setattr(RoundFeed, "push", push_then_signal)
    capsys.readouterr()
    assert cv.main(argv(digits, ckpt, "--checkpoint_every_rounds",
                        "10")) == 0
    out = capsys.readouterr().out
    assert "signal 15" in out and "preempted" in out, out
    assert len(calls) == 13
    assert not (ckpt / "TinyMLP.npz").exists()
    assert (ckpt / "TinyMLP.latest").read_text().strip() == \
        "TinyMLP_r00000013.npz"
    monkeypatch.setattr(RoundFeed, "push", push)
    out = _resume(digits, ckpt, capsys)
    assert "TinyMLP_r00000013.npz" in out, out
    _assert_final_bitwise(baseline, ckpt)


def test_buffered_event_cursor_resumes_in_process(tmp_path, digits,
                                                  baseline):
    """The lock-step buffered server through a resume from a mid-run step
    file: the cursor restores the event loop's counters, and the export
    is bitwise the uninterrupted run's (and the sync baseline's)."""
    ckpt = tmp_path / "ckpt"
    flags = argv(digits, ckpt, "--checkpoint_every_rounds", "20",
                 "--server_mode", "buffered")
    full, _ = cv.train(build_parser().parse_args(flags), log=False)
    _assert_final_bitwise(baseline, ckpt)
    mid = ckpt / "TinyMLP_r00000020.npz"
    assert mid.exists()
    # the later step files and the export go: only round 20 is left
    for f in os.listdir(ckpt):
        if f != mid.name:
            os.remove(ckpt / f)
    resumed, _ = cv.train(build_parser().parse_args(
        flags + ["--resume", str(mid)]), log=False)
    assert resumed.event_cursor() == full.event_cursor()
    assert resumed.cohorts_done == full.cohorts_done == resumed.rounds_done
    _assert_final_bitwise(baseline, ckpt)
    shutil.rmtree(ckpt)


def test_cli_finetune_moves_only_the_head(tmp_path, digits, baseline):
    export = str(baseline / "TinyMLP.npz")
    args = build_parser().parse_args(_BASE + [
        "--dataset_dir", digits, "--finetune", "--finetune_path", export])
    learner, row = cv.train(args, max_rounds=3, log=False)
    mask = learner._trainable_mask > 0
    with np.load(export) as z:
        saved = torch.from_numpy(z["arr_0"])
    w, changed = learner.state.weights, learner.state.last_changed >= 0
    # TinyMLP's head is Dense_1: 32 x 10 + 10 coordinates
    assert int(mask.sum()) == 330 and len(row["rounds"]) == 3
    assert torch.equal(w[~mask], saved[~mask])
    assert not changed[~mask].any() and changed[mask].any()


def test_aborted_round_ends_the_run_unsaved(tmp_path, digits):
    """Any loss breaches a threshold of 1e-9: the save due after round 1
    reads that round first, sees the tripped guard and writes nothing."""
    ckpt = tmp_path / "ckpt"
    args = build_parser().parse_args(argv(
        digits, ckpt, "--checkpoint_every_rounds", "1",
        "--nan_threshold", "1e-9"))
    _, row = cv.train(args, max_rounds=4, log=False)
    assert row["aborted"] and len(row["rounds"]) == 1
    assert not ckpt.exists() or not os.listdir(str(ckpt))
