#!/usr/bin/env python3
"""Build variants of the mma.sync conv pair kernel side by side and time
them on the card at the main path's shapes: the gray pair (CIN = 1) at
(2, 1, 384, 1248) f32 and the 64-channel pair at (2, 64, 192, 624) bf16.

    python3 scripts/conv_variants_torch.py [NAME[:EDIT,EDIT...] ...]

A NAME alone is ``superslam_tpu_torch/ops/cuda/conv_pair_mma.cu`` as it
is. An EDIT is either KEY=VALUE, which sets the kernel source's
``constexpr int KEY`` (``p2:NPASS1=2``: the gray pair's conv_b in two
32-channel passes; ``w16:NWARPS=16``, ``r4:RING=4``), or the name of a
diagnostic patch of ``PATCHES`` (``noA``: A operands from registers, no
ldmatrix; ``nomma``: no mma, one ALU operation per product instead;
``nostep``: no tap step at all; ``noprologue``: no CUDA-core conv_a in the
gray pair). Patched variants compute wrong results: they only split the
time. With no argument: ``tree p2:NPASS1=2 nostep:nostep nomma:nomma
noprologue:noprologue``.

Each variant is compiled with the port's nvcc flags into its own library
under ``build/conv_variants/`` (one nvcc per variant, all at once) and
called through the kernel's own C entry points. Unpatched variants are held
against the plain version (max error / max|plain| <= 2e-2). Then every
variant is timed: 4 rounds, in alternating order, of 50 back-to-back
launches between two CUDA events, for each CIN, pooled and unpooled, bf16
out. Prints the card and its power limit, registers and spills from nvcc's
report, and one line per variant, CIN and output kind. Exits non-zero
without a card.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SRC = os.path.join(REPO, "superslam_tpu_torch", "ops", "cuda")
OUT = os.path.join(REPO, "build", "conv_variants")
ENGINE, KERNEL = "conv_mma.cuh", "conv_pair_mma.cu"
DEFAULT = ["tree", "p2:NPASS1=2", "nostep:nostep", "nomma:nomma", "noprologue:noprologue"]
SHAPES = {1: (2, 1, 384, 1248), 64: (2, 64, 192, 624)}

# name: (file, text, replacement)
PATCHES = {
    "noA": (ENGINE, "ldsm_x4(arow[r] + ((axor[r] ^ (2 * ks)) << 4), a);",
            "a[0] = arow[r]; a[1] = axor[r]; a[2] = ks; a[3] = lane;"),
    "nomma": (ENGINE, """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));""",
              "  c[0] += __uint_as_float(a[0] ^ b0);"),
    "nostep": (KERNEL, "    tap_step(acc,", "    if (s < 0) tap_step(acc,"),
    "noprologue": (KERNEL, "for (int p = tid >> 3; p < (TH + 2) * AP;",
                   "for (int p = tid >> 3; p < 0;"),
}


def parse(args: list[str]) -> dict[str, tuple[dict[str, str], list[str]]]:
    variants = {}
    for arg in args:
        name, _, edits = arg.partition(":")
        consts, patches = {}, []
        for edit in filter(None, edits.split(",")):
            if "=" in edit:
                key, value = edit.split("=", 1)
                consts[key] = value
            elif edit in PATCHES:
                patches.append(edit)
            else:
                raise SystemExit(f"conv_variants: unknown edit {edit!r} of {arg!r}")
        variants[name] = (consts, patches)
    return variants


def write_variant(name: str, consts: dict[str, str], patches: list[str]) -> str:
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    shutil.copy(os.path.join(SRC, "common.cuh"), d)
    files = {}
    for f in (ENGINE, KERNEL):
        with open(os.path.join(SRC, f)) as fh:
            files[f] = fh.read()
    for p in patches:
        f, old, new = PATCHES[p]
        if old not in files[f]:
            raise SystemExit(f"conv_variants: patch {p} no longer matches {f}")
        files[f] = files[f].replace(old, new)
    for key, value in consts.items():
        files[KERNEL], n = re.subn(
            rf"constexpr int {key} = [^;]+;", f"constexpr int {key} = {value};", files[KERNEL]
        )
        if n != 1:
            raise SystemExit(f"conv_variants: no constexpr int {key} in {KERNEL}")
    for f, text in files.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return d


def main(argv: list[str]) -> int:
    import torch

    from superslam_tpu_torch.ops.cuda import _build
    from superslam_tpu_torch.ops.cuda.conv import conv_pair_plain, conv_pair_pool_plain, pair_operands

    if not torch.cuda.is_available():
        print("conv_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(f"card: {smi.stdout.strip() or 'not readable'}")
    variants = parse(argv or DEFAULT)

    jobs = {}
    for name, (consts, patches) in variants.items():
        d = write_variant(name, consts, patches)
        lib = os.path.join(d, "lib.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, os.path.join(d, KERNEL)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}")
            return 1
        for block in log.split("Compiling entry function '")[1:]:
            entry = block.split("'")[0]
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            cin = 1 if "conv_pair_mma_kernelILi1E" in entry else 64
            print(f"{name}: CIN {cin} {entry}: {regs and regs.group(1)} registers, "
                  f"{spill and spill.group(1)} B spill stores")
        lib = ctypes.CDLL(path)
        for fn in ("ssl_conv_pair_pool", "ssl_conv_pair"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        libs[name] = lib

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}  # (cin, pool) -> (kernel inputs, output, plain result)
    for cin, shape in SHAPES.items():
        b, c, h, w = shape
        x = rng.uniform(0, 1, shape) if cin == 1 else np.maximum(rng.normal(size=shape), 0)
        x = torch.from_numpy(x.astype(np.float32)).to(dev)
        wa = torch.from_numpy((rng.normal(size=(64, c, 3, 3)) * (0.3 if cin == 1 else 0.05))
                              .astype(np.float32)).to(dev)
        wb = torch.from_numpy((rng.normal(size=(64, 64, 3, 3)) * 0.05).astype(np.float32)).to(dev)
        ba, bb = (torch.from_numpy((rng.normal(size=(64,)) * 0.1).astype(np.float32)).to(dev)
                  for _ in range(2))
        xk = x if cin == 1 else x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        ops = pair_operands(wa, ba, wb, bb)
        for pool, plain in ((True, conv_pair_pool_plain), (False, conv_pair_plain)):
            ref = plain(x, wa, ba, wb, bb).float()
            out = torch.empty(ref.shape, dtype=torch.bfloat16, device=dev,
                              memory_format=torch.channels_last)
            cases[(cin, pool)] = (xk, ops, out, ref)

    def call(lib, cin, pool):
        xk, (wak, bak, wbk, bbk), out, _ = cases[(cin, pool)]
        b, _, h, w = SHAPES[cin]
        fn = lib.ssl_conv_pair_pool if pool else lib.ssl_conv_pair
        err = fn(xk.data_ptr(), wak.data_ptr(), bak.data_ptr(), wbk.data_ptr(), bbk.data_ptr(),
                 out.data_ptr(), b, cin, h, w, 0, stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")

    for name, lib in libs.items():
        if variants[name][1]:
            continue
        for (cin, pool), (_, _, out, ref) in cases.items():
            call(lib, cin, pool)
            torch.cuda.synchronize()
            rel = (out.float() - ref).abs().max().item() / ref.abs().max().item()
            print(f"{name} CIN {cin} pool={pool}: max error / max|plain| {rel:.3g} (limit 2e-2)")
            if not rel <= 2e-2:
                return 1

    def per_call_ms(lib, cin, pool, n=50):
        for _ in range(5):
            call(lib, cin, pool)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            call(lib, cin, pool)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    times = {(name, key): [] for name in libs for key in cases}
    order = list(libs)
    for rnd in range(4):
        for name in order if rnd % 2 == 0 else order[::-1]:
            for key in cases:
                times[(name, key)].append(per_call_ms(libs[name], *key))
    for (name, (cin, pool)), ts in times.items():
        print(f"time {name} CIN {cin} {'pooled' if pool else 'unpooled'} at {SHAPES[cin]}: median "
              f"{statistics.median(ts):.4f} ms a call over 4 x 50 launches "
              f"({', '.join(f'{t:.4f}' for t in ts)})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
