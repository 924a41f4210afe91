"""The port's tooling against the JAX package's: the synthetic-sequence
writer (the same files, byte for byte), the evaluators (the same JSON on the
same files) and the dataset runners on the CPU (``--device cpu``; the KITTI
and TUM runners equal to the port's facade fed the same frames).
Sequences are rendered at 160x120 with 96 keypoints; the runners run
in-process, the port's evaluators as subprocesses; one subprocess runs
writer -> runner -> evaluator and holds that neither jax nor the JAX
package was imported. ``bench_torch.py`` is in test_torch_bench.py."""

import contextlib
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from superslam_tpu_torch.eval.synthetic_sequence import circuit_trajectory
from superslam_tpu_torch.geometry.se3 import Pose3
from superslam_tpu_torch.io.trajectory import (
    rotation_to_quaternion,
    save_trajectory_kitti,
    save_trajectory_tum,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

W, H, KP, N_SEQ = 160, 120, 96, 5
WRITER_ARGS = ["--width", str(W), "--height", str(H), "--max-keypoints", str(KP),
               "--model-dir", os.path.join(REPO, "weights") + os.sep]
CPU = ["--device", "cpu"]
# The test workers share the host's cores: a torch process on all of them
# oversubscribes it (the runners here took minutes a case under six workers).
THREADS = 2


@contextlib.contextmanager
def _argv(argv):
    saved = sys.argv
    sys.argv = list(argv)
    try:
        yield
    finally:
        sys.argv = saved


def _script(rel: str, argv: list[str]) -> None:
    """Run a repo script in-process as its command line would."""
    path = os.path.join(REPO, rel)
    with _argv([path, *argv]):
        runpy.run_path(path, run_name="__main__")


def _subprocess(rel: str, argv: list[str]):
    env = dict(os.environ, SUPERSLAM_NO_LOG_FILE="1", OMP_NUM_THREADS=str(THREADS))
    env.pop("SUPERSLAM_ENABLE_LOOP", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, rel), *argv], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _write(out_dir, fmt: str, script: str = "scripts/make_synthetic_sequence_torch.py",
           frames: int = N_SEQ):
    _script(script, [str(out_dir), "--frames", str(frames), "--format", fmt, *WRITER_ARGS])
    return out_dir


@pytest.fixture(scope="module")
def kitti_seq(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("kitti") / "seq", "kitti")


@pytest.fixture(scope="module")
def tum_seq(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("tum") / "seq", "tum")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.setenv("SUPERSLAM_NO_LOG_FILE", "1")
    for knob in ("SUPERSLAM_ENABLE_LOOP", "SUPERSLAM_DEVICE_TRACKER", "SUPERSLAM_PIPELINE",
                 "SUPERSLAM_DEVICE_KF", "BENCH_DEPTH", "BENCH_BATCH"):
        monkeypatch.delenv(knob, raising=False)


# -- the writer ------------------------------------------------------------------------


def _tree(root) -> dict[str, bytes]:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("fmt", ["kitti", "tum"])
def test_writer_matches_jax_writer(tmp_path, fmt):
    ours = _write(tmp_path / "port", fmt, frames=3)
    theirs = _write(tmp_path / "jax", fmt, "scripts/make_synthetic_sequence.py", frames=3)
    a, b = _tree(ours), _tree(theirs)
    assert sorted(a) == sorted(b)
    assert len(a) == (9 if fmt == "kitti" else 10)  # 3 frames x 2 images + 3 (4) files
    for name in a:
        assert a[name] == b[name], name


# -- the evaluators --------------------------------------------------------------------


def _noisy(poses, seed: int):
    rng = np.random.default_rng(seed)
    return [p * Pose3.expmap(rng.normal(0.0, 0.02, 6)) for p in poses]


def _evaluator_files(tmp_path, kind: str):
    gt = circuit_trajectory(40)
    est = _noisy(gt, 1)
    ts = [0.1 * i for i in range(len(gt))]
    est_path, gt_path = tmp_path / "est.txt", tmp_path / "gt.txt"
    if kind == "kitti":
        save_trajectory_kitti(str(est_path), est)
        save_trajectory_kitti(str(gt_path), gt)
        return est_path, gt_path
    # The estimate's stamps are off by a few ms and one frame is missing, so
    # the association has work to do.
    save_trajectory_tum(str(est_path), est[1:], [t + 0.004 for t in ts[1:]])
    rows = []
    for t, p in zip(ts, gt):
        q = rotation_to_quaternion(p.R)  # x y z w
        if kind == "tum":
            rows.append(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in (*p.t, *q)))
        elif kind == "euroc":
            rows.append(f"{int(round(t * 1e9))}," + ",".join(
                f"{v:.9f}" for v in (*p.t, q[3], q[0], q[1], q[2])))
        else:  # tartan: x y z qx qy qz qw a frame
            rows.append(" ".join(f"{v:.9f}" for v in (*p.t, *q)))
    header = {"tum": "# timestamp tx ty tz qx qy qz qw",
              "euroc": "#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z", "tartan": None}[kind]
    gt_path.write_text("\n".join(([header] if header else []) + rows) + "\n")
    return est_path, gt_path


@pytest.mark.parametrize("kind", ["kitti", "tum", "euroc", "tartan"])
def test_evaluator_matches_jax_evaluator(tmp_path, capsys, kind):
    est, gt = _evaluator_files(tmp_path, kind)
    ours = _subprocess(f"scripts/evaluate_{kind}_torch.py", [str(est), str(gt)])
    capsys.readouterr()
    _script(f"scripts/evaluate_{kind}.py", [str(est), str(gt)])
    theirs = capsys.readouterr().out
    line = ours.strip().splitlines()[-1]
    assert line == theirs.strip().splitlines()[-1]
    assert json.loads(line)["ate_rmse_m"] > 0.005  # the noise shows


# -- the runners -----------------------------------------------------------------------


def _facade_trajectory(cfg, frames, fmt: str, out) -> str:
    """The port's facade on the CPU fed ``frames`` directly: (t, a, b) with
    a, b the stereo pair or the gray image and its depth."""
    from superslam_tpu_torch.slam import SuperSLAM

    slam = SuperSLAM(str(cfg), device="cpu")
    for t, a, b in frames:
        (slam.track_rgbd if fmt == "tum" else slam.track_stereo)(a, b, t)
    slam.save_trajectory(str(out), fmt)
    slam.shutdown()
    return out.read_text()


def test_kitti_runner_equals_the_facade(kitti_seq, tmp_path):
    from examples.example_common import load_gray
    from examples.kitti import load_kitti_sequence

    out = tmp_path / "est.txt"
    _script("examples/kitti_torch.py",
            [str(kitti_seq / "config.yaml"), str(kitti_seq), "--no-viewer", "--out", str(out),
             *CPU])
    rows = out.read_text()
    assert len(rows.strip().splitlines()) == N_SEQ
    frames = [(t, load_gray(lp), load_gray(rp)) for t, lp, rp in load_kitti_sequence(str(kitti_seq))]
    assert rows == _facade_trajectory(kitti_seq / "config.yaml", frames, "kitti",
                                      tmp_path / "direct.txt")


def test_tum_runner_equals_the_facade(tum_seq, tmp_path):
    import cv2

    from examples.tum_rgbd import associate

    out = tmp_path / "est.txt"
    _script("examples/tum_rgbd_torch.py",
            [str(tum_seq / "config.yaml"), str(tum_seq), "--no-viewer", "--out", str(out), *CPU])
    rows = out.read_text()
    assert len(rows.strip().splitlines()) == N_SEQ
    frames = [
        (t, cv2.imread(str(tum_seq / rgb), cv2.IMREAD_GRAYSCALE),
         cv2.imread(str(tum_seq / depth), cv2.IMREAD_UNCHANGED))
        for t, rgb, depth in associate(str(tum_seq))
    ]
    assert rows == _facade_trajectory(tum_seq / "config.yaml", frames, "tum",
                                      tmp_path / "direct.txt")


RECTIFY = """
LEFT.width: {w}
LEFT.height: {h}
LEFT.K: {{rows: 3, cols: 3, data: [320.0, 0.0, 80.0, 0.0, 320.0, 60.0, 0.0, 0.0, 1.0]}}
LEFT.D: {{rows: 1, cols: 5, data: [0.0, 0.0, 0.0, 0.0, 0.0]}}
LEFT.R: {{rows: 3, cols: 3, data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]}}
LEFT.P: {{rows: 3, cols: 4, data: [320.0, 0.0, 80.0, 0.0, 0.0, 320.0, 60.0, 0.0, 0.0, 0.0, 1.0, 0.0]}}
RIGHT.width: {w}
RIGHT.height: {h}
RIGHT.K: {{rows: 3, cols: 3, data: [320.0, 0.0, 80.0, 0.0, 320.0, 60.0, 0.0, 0.0, 1.0]}}
RIGHT.D: {{rows: 1, cols: 5, data: [0.0, 0.0, 0.0, 0.0, 0.0]}}
RIGHT.R: {{rows: 3, cols: 3, data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]}}
RIGHT.P: {{rows: 3, cols: 4, data: [320.0, 0.0, 80.0, -96.0, 0.0, 320.0, 60.0, 0.0, 0.0, 0.0, 1.0, 0.0]}}
"""


def _images(seq):
    names = sorted(os.listdir(seq / "image_0"))
    return [(seq / "image_0" / n, seq / "image_1" / n) for n in names]


def test_euroc_runner_with_rectification(kitti_seq, tmp_path):
    """EuRoC layout (mav0/cam{0,1}/data.csv + data/), identity-rotation
    rectification maps from the LEFT.*/RIGHT.* blocks; TUM rows written."""
    import shutil

    seq = tmp_path / "euroc"
    for cam in ("cam0", "cam1"):
        (seq / "mav0" / cam / "data").mkdir(parents=True)
    lines = ["#timestamp [ns],filename"]
    for i, (lp, rp) in enumerate(_images(kitti_seq)):
        ns = 1403636579763555584 + i * 100000000
        shutil.copy(lp, seq / "mav0" / "cam0" / "data" / f"{ns}.png")
        shutil.copy(rp, seq / "mav0" / "cam1" / "data" / f"{ns}.png")
        lines.append(f"{ns},{ns}.png")
    (seq / "mav0" / "cam0" / "data.csv").write_text("\n".join(lines) + "\n")
    cfg = tmp_path / "euroc.yaml"
    cfg.write_text((kitti_seq / "config.yaml").read_text() + RECTIFY.format(w=W, h=H))
    out = tmp_path / "est.txt"
    _script("examples/euroc_torch.py", [str(cfg), str(seq), "--no-viewer", "--out", str(out), *CPU])
    rows = out.read_text().strip().splitlines()
    assert len(rows) == N_SEQ and all(len(r.split()) == 8 for r in rows)
    assert np.isfinite(np.loadtxt(out)).all()


def test_tartan_runner(kitti_seq, tmp_path):
    import shutil

    seq = tmp_path / "tartan"
    (seq / "image_left").mkdir(parents=True)
    (seq / "image_right").mkdir()
    for i, (lp, rp) in enumerate(_images(kitti_seq)):
        shutil.copy(lp, seq / "image_left" / f"{i:06d}_left.png")
        shutil.copy(rp, seq / "image_right" / f"{i:06d}_right.png")
    out = tmp_path / "est.txt"
    _script("examples/tartan_torch.py",
            [str(kitti_seq / "config.yaml"), str(seq), "--no-viewer", "--out", str(out), *CPU])
    stamps = np.loadtxt(out)[:, 0]
    np.testing.assert_allclose(stamps, 0.1 * np.arange(N_SEQ))


def test_benchmark_runner(kitti_seq, capsys):
    _script("examples/benchmark_torch.py",
            [str(kitti_seq / "config.yaml"), str(kitti_seq), "--warmup", "1", *CPU])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"frames={N_SEQ - 1} ") and "p95=" in line and "fps" in line


def test_multi_sequence_runner(kitti_seq, tmp_path):
    out_dir = tmp_path / "multi"
    _script("examples/multi_sequence_torch.py",
            [str(kitti_seq / "config.yaml"), str(kitti_seq), "--replicate", "2",
             "--out-dir", str(out_dir), *CPU])
    t0 = (out_dir / "seq00.txt").read_text().strip().splitlines()
    t1 = (out_dir / "seq01.txt").read_text().strip().splitlines()
    assert len(t0) == N_SEQ and t0 == t1


def test_runner_needs_a_card_or_the_cpu_flag(kitti_seq, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _script("examples/kitti_torch.py", [str(kitti_seq / "config.yaml"), str(kitti_seq)])


def test_writer_runner_evaluator_import_no_jax(tmp_path):
    """writer -> KITTI runner -> evaluator in one fresh process: neither jax
    nor the JAX package is imported."""
    seq, est = tmp_path / "seq", tmp_path / "est.txt"
    code = (
        "import runpy, sys\n"
        "def run(rel, argv):\n"
        f"    sys.argv = [rel, *argv]\n"
        f"    runpy.run_path({REPO!r} + '/' + rel, run_name='__main__')\n"
        f"run('scripts/make_synthetic_sequence_torch.py', [{str(seq)!r}, '--frames', '3', "
        f"*{WRITER_ARGS!r}])\n"
        f"run('examples/kitti_torch.py', [{str(seq / 'config.yaml')!r}, {str(seq)!r}, "
        f"'--no-viewer', '--out', {str(est)!r}, '--device', 'cpu'])\n"
        f"run('scripts/evaluate_kitti_torch.py', [{str(est)!r}, {str(seq / 'poses_gt.txt')!r}])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'superslam_tpu' or m.startswith('superslam_tpu.'))\n"
        "print('imported:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, SUPERSLAM_NO_LOG_FILE="1", OMP_NUM_THREADS=str(THREADS))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "imported: []"
    assert json.loads(lines[-2])["frames"] == 3
