#!/usr/bin/env python3
"""Build variants of the mma.sync conv pair kernel side by side and time
them on the card at the main path's shape (2, 64, 192, 624) bf16.

    python3 scripts/conv_variants_torch.py [NAME[:EDIT,EDIT...] ...]

A NAME alone is ``superslam_tpu_torch/ops/cuda/conv_pair_mma.cu`` as it
is. An EDIT is either KEY=VALUE, which sets the kernel source's
``constexpr int KEY`` (``w8:NWARPS=8``, ``r4:RING=4``), or the name of a
diagnostic patch of ``PATCHES`` (``noA``: A operands from registers, no
ldmatrix; ``nomma``: no mma, one ALU operation per product instead;
``nostep``: no tap step at all). Patched variants compute wrong results:
they only split the time. With no argument: ``tree w8:NWARPS=8
w16:NWARPS=16 r4:RING=4``.

Each variant is compiled with the port's nvcc flags into its own library
under ``build/conv_variants/`` (one nvcc per variant, all at once) and
called through a C shim. Unpatched variants are held against the plain
version (max error / max|plain| <= 2e-2). Then every variant is timed:
4 rounds, in alternating order, of 50 back-to-back launches between two
CUDA events, pooled and unpooled, bf16 out. Prints the card and its
power limit, registers and spills from nvcc's report, and one line per
variant and output kind. Exits non-zero without a card.
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
DEFAULT = ["tree", "w8:NWARPS=8", "w16:NWARPS=16", "r4:RING=4"]
SHAPE = (2, 64, 192, 624)

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
    "nostep": (KERNEL, "    tap_step<MAXR>(acc,", "    if (s < 0) tap_step<MAXR>(acc,"),
}

SHIM = r"""
#include "conv_mma.cuh"
SSL_EXPORT int variant_conv_pair(const void* x, const void* wa, const float* ba,
                                 const void* wb, const float* bb, void* out, int B, int H,
                                 int W, int pool, void* stream) {
  return int(conv_pair_mma(x, wa, ba, wb, bb, out, B, H, W, 0, pool != 0,
                           reinterpret_cast<cudaStream_t>(stream)));
}
"""


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
    with open(os.path.join(d, "shim.cu"), "w") as fh:
        fh.write(SHIM)
    return d


def main(argv: list[str]) -> int:
    import torch

    from superslam_tpu_torch.ops.cuda import _build
    from superslam_tpu_torch.ops.cuda.conv import _tap_out_in, conv_pair_plain, conv_pair_pool_plain

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
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
               os.path.join(d, KERNEL), os.path.join(d, "shim.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}")
            return 1
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: registers {regs}, spill stores {spills} (bf16/f32 out x unpooled/pooled)")
        lib = ctypes.CDLL(path)
        lib.variant_conv_pair.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        libs[name] = lib

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    b, c, h, w = SHAPE
    x = torch.from_numpy(np.maximum(rng.normal(size=SHAPE), 0).astype(np.float32)).to(dev)
    wa, wb = (torch.from_numpy((rng.normal(size=(c, c, 3, 3)) * 0.05).astype(np.float32)).to(dev)
              for _ in range(2))
    ba, bb = (torch.from_numpy((rng.normal(size=(c,)) * 0.1).astype(np.float32)).to(dev)
              for _ in range(2))
    xk = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wak, wbk = _tap_out_in(wa), _tap_out_in(wb)
    plain = {True: conv_pair_pool_plain(x, wa, ba, wb, bb).float(),
             False: conv_pair_plain(x, wa, ba, wb, bb).float()}
    outs = {pool: torch.empty(ref.shape, dtype=torch.bfloat16, device=dev,
                              memory_format=torch.channels_last) for pool, ref in plain.items()}
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, pool):
        err = lib.variant_conv_pair(xk.data_ptr(), wak.data_ptr(), ba.data_ptr(), wbk.data_ptr(),
                                    bb.data_ptr(), outs[pool].data_ptr(), b, h, w, int(pool), stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")

    for name, lib in libs.items():
        if variants[name][1]:
            continue
        for pool, ref in plain.items():
            call(lib, pool)
            torch.cuda.synchronize()
            rel = (outs[pool].float() - ref).abs().max().item() / ref.abs().max().item()
            print(f"{name} pool={pool}: max error / max|plain| {rel:.3g} (limit 2e-2)")
            if not rel <= 2e-2:
                return 1

    def per_call_ms(lib, pool, n=50):
        for _ in range(5):
            call(lib, pool)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            call(lib, pool)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    times = {(name, pool): [] for name in libs for pool in (True, False)}
    order = list(libs)
    for rnd in range(4):
        for name in order if rnd % 2 == 0 else order[::-1]:
            for pool in (True, False):
                times[(name, pool)].append(per_call_ms(libs[name], pool))
    for (name, pool), ts in times.items():
        print(f"time {name} {'pooled' if pool else 'unpooled'}: median {statistics.median(ts):.4f} "
              f"ms a call over 4 x 50 launches ({', '.join(f'{t:.4f}' for t in ts)})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
