"""Whole runs of the harness on the CPU at tiny size (``run.main`` with
the look for a card skipped): the last line's keys, a cell, a traffic mix
and a per-layer metric added as new files only, no JAX loaded, and
``correct`` false with the timed path broken underneath."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

import manifest
import run
import tiny

torch.set_num_threads(2)
ARGS = ["--workload", "tiny.drive", "--seed", str(2 ** 33 + 5), "--seconds", "5",
        "--trace", "0"]


def _run(tmp, patch=None):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(ARGS, device="cpu", patch=patch, root=tmp)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("tree")), frames=10)


def test_last_line_keys(tree):
    line = _run(tree)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"fps", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(tiny.LIMITS)


def test_added_files_are_found(tree):
    """A new cell (tiny.drive: a config, a traffic mix and a cell file) and
    a new per-layer metric are found without editing any file."""
    with open(os.path.join(tree, "portbench", "metrics", "drives.py"), "w") as f:
        f.write("def read(record):\n    return len(record['window'].sessions)\n")
    path = os.path.join(tree, "BENCHMARK.json")
    with open(path) as f:
        m = json.load(f)
    m["per_layer"].append({"name": "drives", "unit": "drives", "better": "higher",
                           "source": "program_counter", "layer": "Host driver",
                           "moves": "fps", "workloads": ["tiny.drive"]})
    with open(path, "w") as f:
        json.dump(m, f)
    cell = manifest.cell("tiny.drive", tree, os.path.join(tree, "portbench"))
    assert cell.traffic["route"]["kind"] == "arc" and cell.config["source"] == "tiny_config"
    names = [x["name"] for x in cell.per_layer]
    assert "drives" in names and "attempt_frame_ms_p50" not in names

    class W:
        sessions = [(10, 0, 0, 0)] * 3
    assert cell.readers["drives"]({"window": W}) == 3


def test_split_metric_shares_its_reader(tree):
    """A per-layer metric split by the end-to-end metric it moves
    (``<metric>.<suffix>``) is read by ``metrics/<metric>.py`` unless a
    reader of its own name is there."""
    bench = os.path.join(tree, "portbench")
    assert manifest.reader_path(bench, "step_busy_ms.p99") == \
        os.path.join(bench, "metrics", "step_busy_ms.py")
    assert manifest.reader_path(bench, "untraced_fps") == \
        os.path.join(bench, "metrics", "untraced_fps.py")


def test_untraced_fps_reads_the_calls_before_the_profiler(tree):
    bench = os.path.join(tree, "portbench")
    read = manifest._reader(manifest.reader_path(bench, "untraced_fps"))

    class W:
        calls = [(0, 0), (0, 1), (1, 0), (1, 1)]
        latency_s = [0.01, 0.03, 0.5, 0.5]
        clean = [True, True, False, False]
    assert read({"window": W, "chunk": 1}) == pytest.approx(50.0)
    W.clean = [False] * 4
    assert read({"window": W, "chunk": 1}) is None


def _state_unchanged(pkg):
    from alego_tpu_torch.models import pipeline
    pipeline.commit = lambda dst, src: None


def _half_the_scan(pkg):
    from alego_tpu_torch.models import pipeline
    feed = pipeline.FrameInputs.feed

    def half(self, points, mask, t):
        mask = mask.copy()
        mask[mask.shape[0] // 2:] = False
        return feed(self, points, mask, t)
    pipeline.FrameInputs.feed = half


def _pose_altered(pkg):
    from alego_tpu_torch.models import pipeline
    frame_pose = pipeline.frame_pose

    def moved(*a, **kw):
        T = frame_pose(*a, **kw).clone()
        T[0, 3] += 0.01
        return T
    pipeline.frame_pose = moved


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_scan, _pose_altered])
def test_broken_path_is_not_correct(tree, fault):
    from alego_tpu_torch.models import pipeline
    saved = (pipeline.commit, pipeline.FrameInputs.feed, pipeline.frame_pose)
    try:
        line = _run(tree, patch=fault)
    finally:
        pipeline.commit, pipeline.FrameInputs.feed, pipeline.frame_pose = saved
    assert line["correct"] is False, line["checks"]


def test_no_jax_in_a_run(tree):
    code = ("import sys; sys.path.insert(0, 'portbench'); import run; "
            f"rc = run.main({ARGS!r}, device='cpu', root={tree!r}); "
            "print('forbidden', run.forbidden_modules()); sys.exit(rc)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "forbidden []" in out.stdout


def test_chunked_calls_compare_the_keyframes(tmp_path):
    """A chunked feed (the survey's): the reference runs each sampled call
    whole, and its last frame, the keyframes and the counts after it are
    compared as well as its first frames."""
    line = _run(tiny.make(str(tmp_path), frames=12, chunk=4))
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == set(tiny.LIMITS)
