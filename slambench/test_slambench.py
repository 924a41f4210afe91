"""The benchmark's own tests: ``python -m pytest slambench -q`` from the root.

On the CPU they check the manifest against the contract's characters, that
every cell's files are found by name (and that a new configuration,
traffic mix, metric, layer and matcher are found by adding files alone),
the work arithmetic against hand counts, and whole runs of tiny cells
through the port's CPU path: sound runs come out correct; the control (the
reference at float8 in the program's place) and the program's faults do
not. Tests marked ``gpu`` run the real cells on a card and skip without
one.
"""

from __future__ import annotations

import ast
import copy
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from slambench import compare, flops, harness, render
from slambench.devtrace import attribute, gaps, idle_by_span, union
from slambench.manifest import NAME, UNIT, Manifest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))

# Tiny stand-ins of the two cells: the same entries, reference and limits
# at a size the CPU runs in seconds.
TINY = {
    "tiny.stereo": ("kitti00-stereo", "fleet16", "kitti00-stereo.fleet16",
                    {"width": 320, "height": 192, "fx": 180.0, "fy": 180.0, "cx": 160.0, "cy": 96.0,
                     "bf": 180.0 * 0.54}, {"streams": 2, "warm_steps": 2, "check_steps": 2}),
    "tiny.rgbd": ("tum1-rgbd", "batch16", "tum1-rgbd.batch16",
                  {"width": 320, "height": 192, "fx": 200.0, "fy": 200.0, "cx": 160.0, "cy": 96.0},
                  {"batch": 2, "depth": 3, "warm_steps": 4, "check_steps": 2}),
}
TINY_K = 128


def _tiny_checkout(dst: str) -> str:
    """A checkout holding the benchmark and the tiny cells' files only."""
    bench = os.path.join(dst, "slambench")
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    os.symlink(os.path.join(ROOT, "weights"), os.path.join(dst, "weights"))
    data = copy.deepcopy(BENCH)
    for name, (config, traffic, limits, cam, tr) in TINY.items():
        cfg = json.load(open(os.path.join(HERE, "configs", f"{config}.json")))
        cfg["name"] = f"{name}-config"
        cfg["camera"].update(cam)
        cfg["superpoint"]["max_keypoints"] = TINY_K
        cfg["assumed"]["world"].update(frames=6, scale=cfg["assumed"]["world"]["scale"] * cam["fx"] / cfg["camera"]["fx"])
        with open(os.path.join(bench, "configs", f"{name}-config.json"), "w") as f:
            json.dump(cfg, f)
        t = json.load(open(os.path.join(HERE, "traffic", f"{traffic}.json")))
        t.update(tr)
        with open(os.path.join(bench, "traffic", f"{name}-traffic.json"), "w") as f:
            json.dump(t, f)
        shutil.copy(os.path.join(HERE, "limits", f"{limits}.json"),
                    os.path.join(bench, "limits", f"{name}.json"))
        data["configs"].append({"name": f"{name}-config", "source": "tiny", "reduced": [],
                                "file": f"slambench/configs/{name}-config.json", "why": "tiny"})
        data["workloads"].append({"name": name, "config": f"{name}-config", "chips": 1,
                                  "traffic": f"{name}-traffic", "why": "tiny"})
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)
    return dst


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = _tiny_checkout(str(tmp_path_factory.mktemp("checkout")))
    saved = render.CACHE_DIR
    render.CACHE_DIR = os.path.join(root, "cache")
    yield Manifest(root, os.path.join(root, "slambench"))
    render.CACHE_DIR = saved


def _run(man, workload, seed=20260, control=None):
    return harness.run_cell(workload, seed, 4.0, False, torch.device("cpu"), time.monotonic(),
                            manifest=man, log=lambda s: None, control=control)


def _lightglue():
    return Manifest().matcher("lightglue")


# -- the manifest --------------------------------------------------------------


def test_manifest_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p for p in BENCH["paths"])
    groups = [[c["name"] for c in BENCH["configs"]], [w["name"] for w in BENCH["workloads"]],
              [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]]
    for g in groups:
        assert len(set(g)) == len(g)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for n in sum(groups, []) + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("slambench/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for text in [c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_every_cells_files_are_found_by_name():
    man = Manifest()
    for w in BENCH["workloads"]:
        cfg = man.config(w["config"])
        tr = man.traffic(w["traffic"])
        entry = man.entry(tr["entry"])
        assert entry.VIEWS in (1, 2) and hasattr(entry, "Entry")
        assert set(man.limits(w["name"])) >= {"kpt_miss_pct", "desc_err", "track_disagree_pct"}
        assert cfg["name"] == w["config"]
        matcher = man.matcher(cfg["matcher"])
        assert cfg[matcher.BLOCK] and callable(matcher.work) and hasattr(matcher, "Reference")
        for m in man.per_layer(w["name"]):
            assert callable(man.reader(m["name"]).read)
    assert {ly["layer"] for ly in man.layers()} >= {"detector", "matcher"}


def test_a_new_cell_metric_and_layer_are_files_alone(tmp_path):
    root = _tiny_checkout(str(tmp_path))
    bench = os.path.join(root, "slambench")

    def digests():
        return {p: hashlib.sha1(open(p, "rb").read()).hexdigest()
                for p in glob.glob(os.path.join(bench, "**", "*"), recursive=True) if os.path.isfile(p)}

    before = digests()
    cfg = json.load(open(os.path.join(bench, "configs", "tiny.stereo-config.json")))
    cfg["name"] = "throwaway-config"
    with open(os.path.join(bench, "configs", "throwaway-config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "throwaway.json"), "w") as f:
        json.dump({"entry": "multi_stereo", "streams": 3, "keyframe_every": 3, "warm_steps": 1,
                   "check_steps": 1}, f)
    with open(os.path.join(bench, "limits", "throwaway-config.throwaway.json"), "w") as f:
        json.dump({"kpt_miss_pct": 1.0}, f)
    with open(os.path.join(bench, "metrics", "throwaway_ms.py"), "w") as f:
        f.write("def read(run):\n    return 1.5\n")
    with open(os.path.join(bench, "layers", "throwaway.json"), "w") as f:
        json.dump({"layer": "throwaway", "patterns": ["throwaway_kernel"]}, f)
    data = json.load(open(os.path.join(root, "BENCHMARK.json")))
    data["configs"].append({"name": "throwaway-config", "source": "a throwaway", "reduced": [],
                            "file": "slambench/configs/throwaway-config.json", "why": "a throwaway"})
    data["workloads"].append({"name": "throwaway-config.throwaway", "config": "throwaway-config",
                              "traffic": "throwaway", "chips": 1, "why": "a throwaway cell"})
    data["per_layer"].append({"name": "throwaway_ms", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "throwaway",
                              "moves": "frames_per_s", "workloads": ["throwaway-config.throwaway"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)
    man = Manifest(root, bench)
    assert man.traffic("throwaway")["streams"] == 3
    assert man.config("throwaway-config")["name"] == "throwaway-config"
    assert man.limits("throwaway-config.throwaway") == {"kpt_miss_pct": 1.0}
    assert [m["name"] for m in man.per_layer("throwaway-config.throwaway")][-1] == "throwaway_ms"
    assert "throwaway_ms" not in [m["name"] for m in man.per_layer("tiny.stereo")]
    assert man.reader("throwaway_ms").read(None) == 1.5
    assert "throwaway" in [ly["layer"] for ly in man.layers()]
    after = digests()
    assert all(after[p] == d for p, d in before.items())


def _add_cell(root: str, name: str, like: str, edit) -> None:
    """A cell ``name`` of its own configuration and limits, copied from tiny
    cell ``like`` with ``edit(config)`` applied, on ``like``'s traffic."""
    bench = os.path.join(root, "slambench")
    cfg = json.load(open(os.path.join(bench, "configs", f"{like}-config.json")))
    cfg["name"] = f"{name}-config"
    edit(cfg)
    with open(os.path.join(bench, "configs", f"{name}-config.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(bench, "limits", f"{like}.json"), os.path.join(bench, "limits", f"{name}.json"))
    data = json.load(open(os.path.join(root, "BENCHMARK.json")))
    data["configs"].append({"name": f"{name}-config", "source": "tiny", "reduced": [],
                            "file": f"slambench/configs/{name}-config.json", "why": "tiny"})
    data["workloads"].append({"name": name, "config": f"{name}-config", "chips": 1,
                              "traffic": f"{like}-traffic", "why": "tiny"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)


class _Clock:
    """``time.time_ns`` advancing a fixed tick a call, so that a window holds
    the same dispatches in every run of the same code."""

    def __init__(self, tick_ns: int):
        self.t, self.tick = 0, tick_ns

    def __call__(self) -> int:
        self.t += self.tick
        return self.t


def test_a_new_matcher_is_files_alone(tmp_path, monkeypatch):
    """A matcher that is LightGlue under another block name, added as files
    only (its module, configurations without a ``"lightglue"`` block, their
    cells), runs each tiny cell as the LightGlue configuration does."""
    root = _tiny_checkout(str(tmp_path))
    bench = os.path.join(root, "slambench")
    monkeypatch.setattr(render, "CACHE_DIR", os.path.join(root, "cache"))

    def digests():
        return {p: hashlib.sha1(open(p, "rb").read()).hexdigest()
                for p in glob.glob(os.path.join(bench, "**", "*"), recursive=True) if os.path.isfile(p)}

    before = digests()
    src = open(os.path.join(bench, "matchers", "lightglue.py")).read()
    assert src.count('BLOCK = "lightglue"') == 1
    with open(os.path.join(bench, "matchers", "other.py"), "w") as f:
        f.write(src.replace('BLOCK = "lightglue"', 'BLOCK = "other"'))

    def rename(cfg):
        cfg["other"] = cfg.pop("lightglue")
        cfg["matcher"] = "other"

    for like in sorted(TINY):
        _add_cell(root, like.replace("tiny", "other"), like, rename)
    man = Manifest(root, bench)
    assert "lightglue" not in man.config("other.rgbd-config")
    work = []
    window_work = flops.window_work
    monkeypatch.setattr(flops, "window_work", lambda *a: work.append(window_work(*a)) or work[-1])
    got = {}
    for cell in ["tiny.rgbd", "other.rgbd", "tiny.stereo", "other.stereo"]:
        monkeypatch.setattr(time, "time_ns", _Clock(50_000_000))
        r = _run(man, cell)
        rates = {k: v for k, v in r["metrics"].items() if k != "setup_s"}
        got[cell] = (r["correct"], r["attempted"], rates, r["checks"], work[-1])
    for like in sorted(TINY):
        assert got[like][0], got[like]
        assert got[like.replace("tiny", "other")] == got[like]
    after = digests()
    assert all(after[p] == d for p, d in before.items())


@pytest.mark.parametrize("matcher", [None, "nowhere"])
def test_a_configuration_must_name_a_matcher_file(tmp_path, monkeypatch, matcher):
    """Without a ``"matcher"`` key, or with one that names no file, a run
    stops with the reason before its set-up renders a frame."""
    root = _tiny_checkout(str(tmp_path))

    def edit(cfg):
        cfg.pop("matcher")
        if matcher is not None:
            cfg["matcher"] = matcher

    _add_cell(root, "unmatched", "tiny.rgbd", edit)

    def frame_set(*a):
        raise AssertionError("set-up began")

    monkeypatch.setattr(render, "frame_set", frame_set)
    with pytest.raises(KeyError, match="matcher"):
        _run(Manifest(root, os.path.join(root, "slambench")), "unmatched")


# -- the arithmetic ------------------------------------------------------------


def test_superpoint_flops_by_hand():
    # 8 x 16 pixels: full, half, quarter and eighth resolution have 128, 32, 8 and 2 pixels.
    by_hand = 2 * 9 * (1 * 64 + 64 * 64) * 128 + 2 * 9 * (64 * 64 * 2) * 32 \
        + 2 * 9 * (64 * 128 + 128 * 128) * 8 \
        + 2 * (9 * (128 * 128 * 2 + 128 * 256 * 2) + 256 * 65 + 256 * 256) * 2
    assert flops.superpoint_flops(8, 16) == by_hand
    assert flops.superpoint_flops(7, 13) == by_hand  # the least size is the multiple of 8 above


def test_lightglue_flops_by_hand():
    d, n0, n1 = 8, 2, 3
    t = n0 + n1
    linears = (2 * d * 3 * d + 2 * d * d + 2 * 2 * d * 2 * d + 2 * 2 * d * d) \
        + (3 * 2 * d * d + 2 * 2 * d * 2 * d + 2 * 2 * d * d)
    attn = 2 * 2 * d * (n0 * n0 + n1 * n1) + 2 * 2 * d * (2 * n0 * n1)
    by_hand = 2 * d * d * t + (linears * t + attn) + (2 * d * d * t + 2 * n0 * n1 * d + 2 * d * t) \
        + 2 * 2 * (d // 2 // 2) * t
    assert _lightglue().lightglue_flops(n0, n1, d, 1, 2) == by_hand


def test_bytes_by_hand():
    assert flops.superpoint_params() == 1_300_865  # SuperPoint's 1.3 M parameters
    assert flops.superpoint_bytes(8, 16, 2, 4) == 8 * 16 + 2 * 1_300_865 + 2 * (8 + 1 + 16)
    # Linear weights and biases of one layer at width 8: input 72, the blocks 1320, the head 72 + 9.
    lg = _lightglue()
    assert lg.lightglue_linear_params(8, 1) == 72 + 1320 + 72 + 9
    assert lg.lightglue_bytes(2, 3, 8, 1) == 5 * (8 + 1 + 32) + 2 * 1473 + 4 * 2
    assert flops.least_seconds(989e12, 1.0) == 1.0 and flops.least_seconds(1.0, 3.35e12) == 1.0


def test_window_work_counts_images_and_pairs():
    cfg = json.load(open(os.path.join(HERE, "configs", "kitti00-stereo.json")))
    lg = _lightglue()
    w = flops.window_work(cfg, lg, [(32, [(600, 600)] * 32), (2, [(500, 400)])])
    assert w["detector_flops"] == 34 * flops.superpoint_flops(376, 1241)
    assert w["matcher_flops"] == 32 * lg.lightglue_flops(600, 600, 256, 9, 4) \
        + lg.lightglue_flops(500, 400, 256, 9, 4)
    assert w["matcher_bytes"] == 32 * lg.lightglue_bytes(600, 600, 256, 9) \
        + lg.lightglue_bytes(500, 400, 256, 9)
    assert lg.work(cfg, 500, 400) == (lg.lightglue_flops(500, 400, 256, 9, 4),
                                      lg.lightglue_bytes(500, 400, 256, 9))
    # SuperPoint at 1248 x 376 is some 80 GFLOP, LightGlue at K 600 some 41.
    assert 79e9 < flops.superpoint_flops(376, 1241) < 82e9
    assert 40e9 < lg.lightglue_flops(600, 600, 256, 9, 4) < 42e9


# -- the trace -------------------------------------------------------------------


def test_trace_union_gaps_spans_and_layers():
    ops = [("conv_pair_mma_kernel<1>", 0, 10), ("vectorized_elementwise_kernel add", 10, 12),
           ("attn_fwd_bf16_kernel", 15, 20), ("elementwise_kernel where", 18, 25),
           ("Memcpy HtoD (Pinned -> Device)", 30, 31), ("mystery", 31, 32)]
    busy = union(ops)
    assert busy == [(0, 12), (15, 25), (30, 32)]
    idle = gaps(busy, 0, 40)
    assert idle == [(12, 15), (25, 30), (32, 40)]
    spans = [("issue", 11, 14), ("readback", 24, 29)]
    got = idle_by_span(idle, spans)
    assert got["issue"] == pytest.approx(2e-9) and got["readback"] == pytest.approx(4e-9)
    assert got["outside"] == pytest.approx((1 + 1 + 8) * 1e-9)
    layers = Manifest().layers()
    assert attribute(ops, layers) == ["detector", "detector", "matcher", "matcher", "transfer", None]


def test_readers_on_a_known_trace():
    from slambench.devtrace import Trace

    man = Manifest()
    cfg = man.config("kitti00-stereo")
    work = flops.window_work(cfg, man.matcher(cfg["matcher"]), [(32, [(600, 600)] * 32)] * 250)
    tr = Trace(window_s=10.0, busy_s=8.0, layer_s={"detector": 4.0, "matcher": 3.5})
    spans = [("prep_upload", 0, 7_000_000), ("issue", 7_000_000, 17_000_000)] * 2
    lat = [float(i) for i in range(1, 101)]
    run = harness.Run(cfg, {}, "kitti00-stereo.fleet16", 10.0, 250, 4000, lat, 9.5, spans, work,
                      {}, 700.0, tr)
    got = {m["name"]: man.reader(m["name"]).read(run)
           for m in man.per_layer("kitti00-stereo.fleet16") + man.end_to_end("kitti00-stereo.fleet16")}
    assert got["frames_per_s"] == 400.0 and got["setup_s"] == 9.5
    assert got["step_latency_p95_ms"] == pytest.approx(95.05)
    assert got["dispatch_ms"] == pytest.approx(17.0)
    assert got["step_device_ms"] == pytest.approx(32.0)
    assert got["device_idle_pct"] == pytest.approx(20.0)
    assert got["step_mfu_pct"] == pytest.approx(
        100 * (work["detector_flops"] + work["matcher_flops"]) / (10.0 * flops.PEAK_FLOPS))
    assert 0 < got["detector_roofline_pct"] < 100 and 0 < got["matcher_roofline_pct"] < 100
    empty = harness.Run(cfg, {}, "x", 10.0, 0, 0, [1.0], 1.0, [], work, {}, None, Trace(10.0, 0.0))
    layer = [m["name"] for m in man.per_layer("kitti00-stereo.fleet16")]
    assert all(man.reader(n).read(empty) is None for n in layer)


# -- the check, on the CPU at a tiny size ---------------------------------------------


@pytest.mark.parametrize("workload", sorted(TINY))
def test_reference_against_the_port_at_a_tiny_size(tiny, workload):
    r = _run(tiny, workload)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["metrics"]["frames_per_s"]["value"] > 0 and r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_control_is_not_correct(tiny, workload):
    cfg = tiny.config(tiny.workload(workload)["config"])
    ref = harness.check_reference(cfg, tiny.matcher(cfg["matcher"]), tiny.root, "cpu", "fp8")
    r = _run(tiny, workload, control=lambda units: compare.program_like(ref, units, cfg))
    assert not r["correct"], r["checks"]


def _step_fault(kind: str, rows: int):
    """A wrapper of a step function that breaks it underneath the harness."""

    def wrap(step):
        def broken(sp, lg, images, kf_kpts, kf_desc, kf_valid, **kw):
            if kind == "state":  # the keyframe state never advances
                kf_kpts, kf_desc, kf_valid = (torch.zeros_like(kf_kpts), torch.zeros_like(kf_desc),
                                              torch.zeros_like(kf_valid))
            if kind == "half":  # half of the batch left out, filled from the rest
                kf = (kf_kpts, kf_desc, kf_valid)
                if kf_kpts.dim() == 3:  # per-stream keyframes
                    kf = tuple(t[: t.shape[0] // 2] for t in kf)
                out = step(sp, lg, images[: images.shape[0] // 2], *kf, **kw)
                return tuple(torch.cat([t, t]) for t in out)
            p, d, k, v = step(sp, lg, images, kf_kpts, kf_desc, kf_valid, **kw)
            if kind == "answer":  # every track answer points at the next keypoint
                p = p.clone()
                tr = p.view(-1, rows, p.shape[-1])[:, rows - 1]
                tr[tr >= 0] += 1
            return p, d, k, v

        return broken

    return wrap


@pytest.mark.parametrize("kind", ["state", "half", "answer"])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_broken_step_is_not_correct(tiny, workload, kind, monkeypatch):
    from superslam_tpu_torch.ops import frontend_step, rgbd_step

    if workload == "tiny.stereo":
        mod, name, rows = frontend_step, "fused_stereo_step_multi", 4
    else:
        mod, name, rows = rgbd_step, "fused_rgbd_step_multi", 3
    monkeypatch.setattr(mod, name, _step_fault(kind, rows)(getattr(mod, name)))
    r = _run(tiny, workload)
    assert not r["correct"], r["checks"]


# -- what the benchmark loads --------------------------------------------------------


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "superslam_tpu"}
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in banned, (path, n)


def test_only_the_matcher_modules_name_lightglue():
    """What is LightGlue's sits in ``matchers/lightglue.py``: no other source
    of the benchmark names it, its configuration block or its parameters
    (the tests aside, which test that module)."""
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        rel = os.path.relpath(path, HERE)
        if rel.startswith("matchers" + os.sep) or os.path.basename(rel).startswith("test_"):
            continue
        text = open(path).read()
        for word in ("lightglue", "lightglue_", "lg_params"):
            assert word not in text, (rel, word)


def test_a_run_loads_no_jax_module(tmp_path):
    root = _tiny_checkout(str(tmp_path))
    code = (
        "import sys, time, json, torch\n"
        f"sys.path.insert(0, {root!r}); sys.path.insert(1, {ROOT!r})\n"
        "from slambench import harness, render\n"
        "from slambench.manifest import Manifest\n"
        f"render.CACHE_DIR = {os.path.join(root, 'cache')!r}\n"
        f"man = Manifest({root!r}, {os.path.join(root, 'slambench')!r})\n"
        "harness.run_cell('tiny.rgbd', 5, 4.0, False, torch.device('cpu'), time.monotonic(), "
        "manifest=man, log=lambda s: None)\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


# -- on the card -------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_runs_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", workload,
                          "--seed", "3141592653", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_on_the_card_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from slambench.calibrate import readings

    out = readings(workload, [], [2718281828], 2.0, "cuda", Manifest(), log=lambda s: None)
    assert not out["runs"][0]["correct"], out["runs"][0]
