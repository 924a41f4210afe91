"""SuperPoint's first convs as hand-written kernels.

``conv_pair_pool`` computes maxpool2x2(relu(conv_b(relu(conv_a(x) + ba)) +
bb)) with two 3x3 SAME convs. It is the port of
``superslam_tpu/ops/pallas/conv.py::conv1a1b_chw`` (CIN = 1, the gray
image) and ``::conv_pair_chw`` (CIN = 64), both with ``pool_vert=True``
plus the XLA ``hpool_canvas`` that finishes their pool. ``conv_pair`` is
the same two convs without the pool (the same two JAX functions without
``pool_vert``), and ``conv3x3`` one 3x3 SAME conv + bias + optional ReLU
(``::conv3x3_chw``); the stage profiler and the tests call these two. Both
pairs (CIN 1 and 64, pooled and not) are ``conv_pair_mma.cu``, and
``conv3x3`` is ``conv3x3_mma.cu``: all on the mma.sync engine of
``conv_mma.cuh``, whose shared-memory address model ``mma_layout`` below
mirrors (``conv3x3`` with CIN = 1 stays on the CUDA cores). Each header says
what bounds its kernels on the H100 and how the design answers that.

The kernels take their weights in their own layout (``pair_operands``,
``conv3x3_operands``). The wrappers accept OIHW weights and lay them out on
every call, or take the operands prepared once (``operands=``, as
``models/superpoint.py::prepare_superpoint_params`` keeps the pairs') and
then launch the kernel alone.

The TPU kernels work on a padded "canvas" (PAD_ROWS zero rows, lanes
padded to 128, the image width passed beside it): that is its compiler's
layout, not the function. Here every function takes (B, CIN, H, W) and
returns (B, COUT, H, W) or its pooled half.

A CUDA tensor always goes through the kernel (or raises); a CPU tensor
goes through the ``*_plain`` function beside each wrapper, the same
function in plain PyTorch. On CUDA the convs compute in bf16 with f32
accumulation: the conv_a map is rounded to bf16 in shared memory, as the
TPU kernel rounds it in VMEM. Launches count as ``conv1a1b`` / ``conv_pair``
(pooled, CIN 1 / 64), ``conv1a1b_full`` / ``conv_pair_full`` (unpooled) and
``conv3x3``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

C = 64


def conv_pair_pool_plain(
    x: torch.Tensor,
    wa: torch.Tensor,
    ba: torch.Tensor,
    wb: torch.Tensor,
    bb: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """F.conv2d -> ReLU -> F.conv2d -> ReLU -> F.max_pool2d in compute_dtype
    (NCHW, OIHW weights). Each bias is added after the conv's rounding to
    compute_dtype, as the JAX package's XLA route does."""
    cdt = compute_dtype
    y = F.relu(F.conv2d(x.to(cdt), wa.to(cdt), padding=1) + ba.to(cdt)[:, None, None])
    y = F.relu(F.conv2d(y, wb.to(cdt), padding=1) + bb.to(cdt)[:, None, None])
    return F.max_pool2d(y, 2).to(out_dtype or cdt)


def conv_pair_plain(
    x: torch.Tensor,
    wa: torch.Tensor,
    ba: torch.Tensor,
    wb: torch.Tensor,
    bb: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``conv_pair_pool_plain`` without the pool."""
    cdt = compute_dtype
    y = F.relu(F.conv2d(x.to(cdt), wa.to(cdt), padding=1) + ba.to(cdt)[:, None, None])
    y = F.relu(F.conv2d(y, wb.to(cdt), padding=1) + bb.to(cdt)[:, None, None])
    return y.to(out_dtype or cdt)


def conv3x3_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    relu: bool = True,
    out_dtype: torch.dtype | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """F.conv2d (+ ReLU) in compute_dtype (NCHW, OIHW weights); the bias is
    added after the conv's rounding to compute_dtype, as in
    ``conv_pair_pool_plain``."""
    cdt = compute_dtype
    y = F.conv2d(x.to(cdt), w.to(cdt), padding=1) + b.to(cdt)[:, None, None]
    return (F.relu(y) if relu else y).to(out_dtype or cdt)


def pair_operands(wa, ba, wb, bb) -> tuple[torch.Tensor, ...]:
    """The pair kernel's weight operands from OIHW weights: conv_a as f32
    (64, 9) for CIN = 1 or bf16 (tap, co, ci) for CIN = 64, conv_b as bf16
    (tap, co, ci), both biases as contiguous f32."""
    wak = wa.float().reshape(C, 9).contiguous() if wa.shape[1] == 1 else _tap_out_in(wa)
    return wak, ba.float().contiguous(), _tap_out_in(wb), bb.float().contiguous()


def _check_operands(name: str, maker: str, device, operands, specs) -> None:
    """Prepared operands must be what ``maker`` makes, (shape, dtype) in
    ``specs``, contiguous on the input's device: the kernel reads them as raw
    pointers."""
    if len(operands) != len(specs) or not all(
        tuple(t.shape) == shape and t.dtype == dtype and t.device == device and t.is_contiguous()
        for t, (shape, dtype) in zip(operands, specs)
    ):
        got = [(tuple(t.shape), t.dtype, str(t.device)) for t in operands]
        raise ValueError(f"{name}: prepared operands {got} are not those of {maker}: {specs}")


def _check_aligned(name: str, xk: torch.Tensor) -> None:
    """The CIN = 64 kernels' cp.async copies read the input 16 bytes at a
    time."""
    if xk.data_ptr() % 16:
        raise ValueError(f"{name}: the input must be 16-byte aligned (storage offset "
                         f"{xk.storage_offset()})")


def _pair_operands(name: str, x, wa, ba, wb, bb, out_dtype, compute_dtype, operands):
    """Checks shared by the two conv pairs; returns the kernel's input, its
    weight operands (``operands`` if given, else ``pair_operands``) and the
    output type. CIN = 64 needs its input 16-byte aligned (the kernel's
    cp.async copies)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel computes in bf16")
    out_dtype = out_dtype or compute_dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported out_dtype {out_dtype}")
    cin = x.shape[1] if x.dim() == 4 else None
    if cin not in (1, C):
        raise ValueError(f"{name}: unsupported input shape {tuple(x.shape)}")
    if tuple(wa.shape) != (C, cin, 3, 3) or tuple(wb.shape) != (C, C, 3, 3):
        raise ValueError(f"{name}: weights {tuple(wa.shape)}, {tuple(wb.shape)}")
    if operands is None:
        operands = pair_operands(wa, ba, wb, bb)
    else:
        wa_spec = ((C, 9), torch.float32) if cin == 1 else ((9, C, C), torch.bfloat16)
        _check_operands(name, "pair_operands", x.device, operands, (
            wa_spec, ((C,), torch.float32), ((9, C, C), torch.bfloat16), ((C,), torch.float32)))
    if cin == 1:
        xk = x.float().contiguous()
    else:
        xk = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        _check_aligned(name, xk)
    return xk, operands, out_dtype


def conv_pair_pool(
    x: torch.Tensor,
    wa: torch.Tensor,
    ba: torch.Tensor,
    wb: torch.Tensor,
    bb: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    operands: tuple[torch.Tensor, ...] | None = None,
) -> torch.Tensor:
    """(B, CIN, H, W) -> (B, 64, H/2, W/2); CIN in {1, 64}, H and W even.

    Weights are OIHW (64, CIN, 3, 3) and (64, 64, 3, 3); ``operands``, if
    given, is ``pair_operands`` of them, prepared once (the CPU path reads
    the OIHW weights). On CUDA the output is a channels_last tensor (NHWC in
    memory) in ``out_dtype`` (bf16 or f32; default compute_dtype), ready for
    the next conv."""
    if x.device.type == "cpu":
        return conv_pair_pool_plain(x, wa, ba, wb, bb, out_dtype, compute_dtype)
    xk, (wak, bak, wbk, bbk), out_dtype = _pair_operands(
        "conv_pair_pool", x, wa, ba, wb, bb, out_dtype, compute_dtype, operands
    )
    b, cin, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"conv_pair_pool: unsupported input shape {tuple(x.shape)}")
    out = torch.empty(
        (b, C, h // 2, w // 2),
        dtype=out_dtype,
        device=x.device,
        memory_format=torch.channels_last,
    )
    err = _build.library().ssl_conv_pair_pool(
        xk.data_ptr(), wak.data_ptr(), bak.data_ptr(), wbk.data_ptr(),
        bbk.data_ptr(), out.data_ptr(), b, cin, h, w,
        int(out_dtype == torch.float32), _build.stream_of(x),
    )
    _build.check(err, "conv_pair_pool")
    _build.count("conv1a1b" if cin == 1 else "conv_pair")
    return out


def conv_pair(
    x: torch.Tensor,
    wa: torch.Tensor,
    ba: torch.Tensor,
    wb: torch.Tensor,
    bb: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    operands: tuple[torch.Tensor, ...] | None = None,
) -> torch.Tensor:
    """relu(conv_b(relu(conv_a(x) + ba)) + bb), no pool: (B, CIN, H, W) ->
    (B, 64, H, W); CIN in {1, 64}. Operands and output as ``conv_pair_pool``."""
    if x.device.type == "cpu":
        return conv_pair_plain(x, wa, ba, wb, bb, out_dtype, compute_dtype)
    xk, (wak, bak, wbk, bbk), out_dtype = _pair_operands(
        "conv_pair", x, wa, ba, wb, bb, out_dtype, compute_dtype, operands
    )
    b, cin, h, w = x.shape
    out = torch.empty(
        (b, C, h, w), dtype=out_dtype, device=x.device, memory_format=torch.channels_last
    )
    err = _build.library().ssl_conv_pair(
        xk.data_ptr(), wak.data_ptr(), bak.data_ptr(), wbk.data_ptr(),
        bbk.data_ptr(), out.data_ptr(), b, cin, h, w,
        int(out_dtype == torch.float32), _build.stream_of(x),
    )
    _build.check(err, "conv_pair")
    _build.count("conv1a1b_full" if cin == 1 else "conv_pair_full")
    return out


def conv3x3_operands(w, b) -> tuple[torch.Tensor, torch.Tensor]:
    """The conv3x3 kernel's operands from OIHW weights (COUT, CIN, 3, 3):
    f32 (COUT, 9) for CIN = 1 or bf16 (tap, co, ci) for CIN = 64, and the
    bias as contiguous f32."""
    cout = w.shape[0]
    wk = w.float().reshape(cout, 9).contiguous() if w.shape[1] == 1 else _tap_out_in(w)
    return wk, b.float().contiguous()


def conv3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    relu: bool = True,
    out_dtype: torch.dtype | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    operands: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """One 3x3 SAME conv + bias (+ ReLU): (B, CIN, H, W) -> (B, COUT, H, W);
    CIN in {1, 64}, COUT in {64, 128}, OIHW weights; ``operands``, if given,
    is ``conv3x3_operands`` of them, prepared once (the CPU path reads the
    OIHW weights). On CUDA the output is a channels_last tensor in
    ``out_dtype`` (bf16 or f32; default compute_dtype); CIN = 64 needs its
    input 16-byte aligned (the kernel's cp.async copies)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu, out_dtype, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("conv3x3: the CUDA kernel computes in bf16")
    out_dtype = out_dtype or compute_dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv3x3: unsupported out_dtype {out_dtype}")
    cin = x.shape[1] if x.dim() == 4 else None
    cout = w.shape[0]
    if cin not in (1, C) or cout not in (C, 2 * C) or tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"conv3x3: input {tuple(x.shape)}, weights {tuple(w.shape)}")
    if tuple(b.shape) != (cout,):
        raise ValueError(f"conv3x3: bias {tuple(b.shape)}")
    if operands is None:
        operands = conv3x3_operands(w, b)
    else:
        w_spec = ((cout, 9), torch.float32) if cin == 1 else ((9, cout, C), torch.bfloat16)
        _check_operands("conv3x3", "conv3x3_operands", x.device, operands,
                        (w_spec, ((cout,), torch.float32)))
    wk, bk = operands
    if cin == 1:
        xk = x.float().contiguous()
    else:
        xk = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        _check_aligned("conv3x3", xk)
    bsz, _, h, wd = x.shape
    out = torch.empty(
        (bsz, cout, h, wd), dtype=out_dtype, device=x.device,
        memory_format=torch.channels_last,
    )
    err = _build.library().ssl_conv3x3(
        xk.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(), bsz, cin, cout, h, wd,
        int(relu), int(out_dtype == torch.float32), _build.stream_of(x),
    )
    _build.check(err, "conv3x3")
    _build.count("conv3x3")
    return out


def _tap_out_in(w: torch.Tensor) -> torch.Tensor:
    """OIHW (co, ci, ky, kx) -> bf16 (ky*3+kx, co, ci), the mma.sync
    kernels' B operand: one 128-byte row of input channels per output
    channel, as ldmatrix loads it without transposing."""
    co, ci = w.shape[0], w.shape[1]
    return w.permute(2, 3, 0, 1).reshape(9, co, ci).to(torch.bfloat16).contiguous()


# conv_pair_mma.cu's NPASS1: the CIN = 1 pair's conv_b passes over the 64
# output channels (one pass: 64-row ring slots).
GRAY_PASSES = 1
# conv3x3_mma.cu's NPASS3: conv3x3's passes over each 64 output channels.
CONV3X3_PASSES = 1
# conv3x3_mma.cu's GRAY_SMEM_BYTES: the CIN = 1 kernel's f32 image tile of
# 18 x 34 pixels and its weights for up to 128 output channels.
CONV3X3_GRAY_SMEM_BYTES = (18 * 34 + 128 * 9) * 4


def mma_layout(tile: str, cin: int = 64) -> dict:
    """The shared-memory address model of ``conv_pair_mma.cu`` (engine in
    ``conv_mma.cuh``), for one of its three regions and the pair's CIN, and
    of ``conv3x3_mma.cu`` (CIN = 64) for its two:

    - ``"x"``: the input region. CIN = 64: the input tile (20 + 1 overrun
      rows of pitch 36 pixels) that conv_a's 41 runs read. CIN = 1: the f32
      image tile (20 rows of pitch 36, 4-byte pixels, not swizzled) that the
      conv_a prologue reads at its nine taps;
    - ``"a"``: the conv_a tile (18 + 1 rows of pitch 34) that conv_b's 34
      runs read;
    - ``"w"``: the weight ring, 3 slots ("rows") of 32 output-channel rows
      ("pitch"; 64 for CIN = 1 in one pass); it has no runs or taps;
    - ``"x3"``: conv3x3's input tile, loaded straight into the layout that
      its 34 runs read (18 + 1 overrun rows of pitch 34, as the pair's
      ``"a"``), at offset 0;
    - ``"w3"``: conv3x3's ring, 3 slots of 64 / CONV3X3_PASSES rows.

    Keys: ``offset`` and ``region`` (the region in the block's dynamic
    shared memory), ``nbytes`` (what the tile occupies of it), ``pitch`` and
    ``rows`` (pixels), ``pixel_bytes``, ``run_starts`` (first pixel of each
    16-pixel run), ``tap_offsets`` (pixel offset of tap ky*3+kx), ``valid``
    (rows x columns of the tile its stage keeps; the conv_a tile's for
    ``"x"``, the output tile's for ``"a"``), ``smem_bytes`` (the whole
    block's); ``address(p, j)``: the byte offset in the region of 16-byte
    chunk ``j`` (channels 8j..8j+7) of pixel or weight row ``p``, stored at
    chunk ``j ^ (p & 7)`` of a 128-byte row (CIN = 1's image tile: pixel
    ``p``'s 4 bytes, ``j`` = 0); ``lane(l, ks)``: the (row, chunk) that lane
    ``l`` hands ``ldmatrix.x4`` at k-step ``ks`` (A: row of the run; B:
    weight row of the 16-row group). CIN = 1's ``"a"`` adds
    ``prologue(t, k)``: the (pixel, chunk) of the conv_a tile that thread
    ``t`` computes and stores as its ``k``-th item, for pixels below
    ``prologue_pixels``.
    """
    th, tw, pix = 16, 32, 128
    if tile in ("x3", "w3"):
        slot_rows, x3_bytes = 64 // CONV3X3_PASSES, 19 * (tw + 2) * pix
        r = dict(offset=0, region=x3_bytes, pitch=tw + 2, rows=19, runs=34, valid=(th, tw))
        if tile == "w3":
            r = dict(offset=x3_bytes, region=3 * slot_rows * pix, pitch=slot_rows, rows=3,
                     runs=0, valid=None)
        return _with_addressing(r, tile[0], pix, x3_bytes + 3 * slot_rows * pix)
    slot_rows = 64 // GRAY_PASSES if cin == 1 else 32
    x_bytes, a_bytes, slot = 21 * (tw + 4) * pix, 19 * (tw + 2) * pix, slot_rows * pix
    regions = {
        "x": dict(offset=0, region=x_bytes, pitch=tw + 4, rows=21, runs=41,
                  valid=(th + 2, tw + 2)),
        "a": dict(offset=x_bytes, region=a_bytes, pitch=tw + 2, rows=19, runs=34, valid=(th, tw)),
        "w": dict(offset=x_bytes + a_bytes, region=3 * slot, pitch=slot_rows, rows=3, runs=0,
                  valid=None),
    }
    r = dict(regions[tile], pixel_bytes=pix)
    if cin == 1 and tile == "x":
        r.update(rows=th + 4, runs=0, pixel_bytes=4)
    r = _with_addressing(r, tile, pix, x_bytes + a_bytes + 3 * slot)
    if cin == 1 and tile == "a":
        r["prologue"] = lambda t, k: ((t >> 3) + 48 * k, t & 7)  # 384 threads, 48 pixels a round
        r["prologue_pixels"] = (th + 2) * (tw + 2)
    return r


def _with_addressing(r: dict, kind: str, pix: int, smem_bytes: int) -> dict:
    """``mma_layout``'s derived keys for a region ``r`` of kind ``"w"`` (a
    ring) or a tile: bytes, runs, taps, the (swizzled) address and the
    ldmatrix lane map."""
    r.setdefault("pixel_bytes", pix)
    r["nbytes"] = r["pitch"] * r["rows"] * r["pixel_bytes"]
    r["run_starts"] = [16 * k for k in range(r.pop("runs"))]
    r["tap_offsets"] = [] if kind == "w" else [ky * r["pitch"] + kx for ky in range(3) for kx in range(3)]
    r["smem_bytes"] = smem_bytes
    if r["pixel_bytes"] == 4:
        r["address"] = lambda p, j=0: 4 * p
    else:
        r["address"] = lambda p, j: p * pix + ((j ^ p) & 7) * 16
    if kind == "w":
        r["lane"] = lambda l, ks: (8 * (l >> 4) + (l & 7), 2 * ks + ((l >> 3) & 1))
    elif r["pixel_bytes"] == pix:
        r["lane"] = lambda l, ks: (l & 15, 2 * ks + (l >> 4))
    return r
