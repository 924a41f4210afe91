"""One whole LightGlue transformer block per call: the fused layer route.

``fused_self_block`` and ``fused_cross_block`` are the ports of
``superslam_tpu/ops/pallas/lightglue_layer.py::fused_self_block`` and
``::fused_cross_block``. The kernels are in ``lightglue_layer.cu`` (three
launches per block call: projection with the rotary epilogue, attention,
the message + FFN tail); its header says what bounds them on the H100 and
how the design answers that. ``gemm_layout`` below is the address model of
its bf16 linears (mma.sync from swizzled tiles and a cp.async weight ring).
A CPU tensor goes through ``fused_self_block_plain`` /
``fused_cross_block_plain``.

The plain versions follow the TPU kernel bodies' rounding points, which
differ from the unfused route's (``models/lightglue.py::_self_block``):
every product accumulates in f32 and adds an f32 bias; the rotary encoding
is applied in f32 with f32 cos/sin before q and k are rounded; LayerNorm
and GELU act on the f32 (K, 512) hidden tile; q, k, v, the attention
probabilities, the context, the message and the GELU output are rounded to
x's type before the product that consumes them. GELU is ``erf``-exact (the
TPU kernel's erf polynomial is within 1.5e-7 of it).

Layouts. Inputs and outputs are (B, K, 256) in the standard channel order.
The TPU kernels' [evens | odds] channel permutation and (K, 256) cos/sin
tiles work around its compiler and are not carried over: the weight
preparation only de-interleaves cvg/LightGlue's (head, channel, qkv)
packing of Wqkv into [q | k | v] column groups (head-major, natural
channel order), transposes every linear to (in, out) and casts once;
cos/sin are (B, K, 32) f32, one frequency per rotary pair (2i, 2i+1). W0
stays whole: cat[x, msg] @ W0 with an f32 accumulator is the TPU kernel's
x @ W0[:256] + msg @ W0[256:].

Any K >= 1 is taken as it is. The JAX route pads K to max(ceil8(K), 128)
with masked keys; the only observable difference is a query row whose keys
are all masked (the keyframe side before the first keyframe), which here
is uniform over K instead of over the padded K. No output reads such a
row: its matches are masked.

The fused blocks are inference-only (they have no backward kernel): called
with autograd recording on an input or a weight that requires grad, they
raise instead of returning a result cut off from the graph. Training goes
through the unfused route (``models/lightglue.py``, ``fused=False``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .attention import masked_attention_plain

DIM = 256
HEADS = 4
HEAD_DIM = 64
FUSED_KEY = "__fused"


# -- weight preparation -------------------------------------------------------


def _t(params, name: str, dtype) -> torch.Tensor:
    """A torch-layout (out, in) linear weight as a contiguous (in, out)
    operand in ``dtype``."""
    return params[f"{name}.weight"].t().to(dtype).contiguous()


def _f32(params, name: str) -> torch.Tensor:
    return params[name].float().contiguous()


def _ffn_operands(params, prefix: str, dtype) -> list[torch.Tensor]:
    return [
        _t(params, f"{prefix}.ffn.0", dtype),
        _f32(params, f"{prefix}.ffn.0.bias"),
        _f32(params, f"{prefix}.ffn.1.weight"),
        _f32(params, f"{prefix}.ffn.1.bias"),
        _t(params, f"{prefix}.ffn.3", dtype),
        _f32(params, f"{prefix}.ffn.3.bias"),
    ]


def prep_self_weights(params, prefix: str, dtype) -> list[torch.Tensor]:
    """Kernel operands of one self-attention block:
    [wqkv (256, 768), bqkv, wout (256, 256), bout, w0 (512, 512), b0,
    ln gain, ln offset, w3 (512, 256), b3]; weights in ``dtype``, the rest
    f32. Served from ``augment_fused_layer_params``' cache when present."""
    pre = params.get(f"{prefix}.{FUSED_KEY}")
    if pre is not None and pre[0].dtype == dtype:
        return pre
    # Wqkv's output index is (head*64 + channel)*3 + j: regroup to
    # j*256 + head*64 + channel.
    w = params[f"{prefix}.Wqkv.weight"].reshape(HEADS, HEAD_DIM, 3, DIM)
    wqkv = w.permute(2, 0, 1, 3).reshape(3 * DIM, DIM).t().to(dtype).contiguous()
    b = params[f"{prefix}.Wqkv.bias"].reshape(HEADS, HEAD_DIM, 3)
    bqkv = b.permute(2, 0, 1).reshape(3 * DIM).float().contiguous()
    return [
        wqkv,
        bqkv,
        _t(params, f"{prefix}.out_proj", dtype),
        _f32(params, f"{prefix}.out_proj.bias"),
        *_ffn_operands(params, prefix, dtype),
    ]


def prep_cross_weights(params, prefix: str, dtype) -> list[torch.Tensor]:
    """Kernel operands of one cross-attention block: as for the self block
    with wqkv (256, 512) = [to_qk | to_v] and to_out for the message."""
    pre = params.get(f"{prefix}.{FUSED_KEY}")
    if pre is not None and pre[0].dtype == dtype:
        return pre
    wqkv = torch.cat([_t(params, f"{prefix}.to_qk", dtype), _t(params, f"{prefix}.to_v", dtype)], 1)
    bqkv = torch.cat([_f32(params, f"{prefix}.to_qk.bias"), _f32(params, f"{prefix}.to_v.bias")])
    return [
        wqkv.contiguous(),
        bqkv,
        _t(params, f"{prefix}.to_out", dtype),
        _f32(params, f"{prefix}.to_out.bias"),
        *_ffn_operands(params, prefix, dtype),
    ]


def augment_fused_layer_params(params, dtype=torch.bfloat16, num_layers: int = 9):
    """A copy of ``params`` with every block's kernel operands prepared
    under ``<prefix>.__fused`` keys, so the regrouping, transposes and casts
    run once at construction and not in every forward. Prepare from the
    f32 checkpoint values (before any compute-dtype cast) when ``dtype`` is
    f32. Partial parameter sets are returned untouched."""
    if "transformers.0.self_attn.Wqkv.weight" not in params:
        return params
    out = {k: v for k, v in params.items() if not k.endswith(FUSED_KEY)}
    for i in range(num_layers):
        sp = f"transformers.{i}.self_attn"
        cp = f"transformers.{i}.cross_attn"
        out[f"{sp}.{FUSED_KEY}"] = prep_self_weights(out, sp, dtype)
        out[f"{cp}.{FUSED_KEY}"] = prep_cross_weights(out, cp, dtype)
    return out


# -- plain versions -----------------------------------------------------------


def _heads(t: torch.Tensor) -> torch.Tensor:
    b, k, _ = t.shape
    return t.reshape(b, k, HEADS, HEAD_DIM).permute(0, 2, 1, 3)


def _context(q, k, v, mask) -> torch.Tensor:
    """(B, K, 256) q, k, v in x's type + (B, K) key mask -> merged context."""
    ctx = masked_attention_plain(_heads(q), _heads(k), _heads(v), mask)
    b, _, n, _ = ctx.shape
    return ctx.permute(0, 2, 1, 3).reshape(b, n, DIM)


def _tail_plain(x, ctx, wout, bout, w0, b0, g, be, w3, b3) -> torch.Tensor:
    dt = x.dtype
    msg = ctx.float() @ wout.float() + bout
    h = torch.cat([x, msg.to(dt)], dim=-1).float() @ w0.float() + b0  # (B, K, 512) f32
    mu = h.mean(dim=-1, keepdim=True)
    var = torch.square(h - mu).mean(dim=-1, keepdim=True)
    hn = (h - mu) * torch.rsqrt(var + 1e-5) * g + be
    y = F.gelu(hn, approximate="none").to(dt).float() @ w3.float() + b3
    return (x.float() + y).to(dt)


def _swap_pairs(a: torch.Tensor) -> torch.Tensor:
    """Rows (2p, 2p+1) -> (2p+1, 2p)."""
    return a.reshape(a.shape[0] // 2, 2, *a.shape[1:]).flip(1).reshape(a.shape)


def fused_self_block_plain(x, cos, sin, mask, weights) -> torch.Tensor:
    """x (B, K, 256); cos, sin (B, K, 32) f32; mask (B, K) bool."""
    wqkv, bqkv, *tail = weights
    dt = x.dtype
    b, k, _ = x.shape
    qkv = x.float() @ wqkv.float() + bqkv  # (B, K, 768) f32, not rounded
    q, kk, v = qkv.split(DIM, dim=-1)

    def rotary(t):
        t = t.reshape(b, k, HEADS, HEAD_DIM // 2, 2)
        t0, t1 = t[..., 0], t[..., 1]
        c, s = cos[:, :, None, :], sin[:, :, None, :]
        return torch.stack([t0 * c - t1 * s, t1 * c + t0 * s], dim=-1).reshape(b, k, DIM)

    ctx = _context(rotary(q).to(dt), rotary(kk).to(dt), v.to(dt), mask)
    return _tail_plain(x, ctx, *tail)


def fused_cross_block_plain(x, mask, weights) -> torch.Tensor:
    """x (2P, K, 256), rows (2p, 2p+1) attend each other; mask (2P, K) bool."""
    wqkv, bqkv, *tail = weights
    dt = x.dtype
    proj = (x.float() @ wqkv.float() + bqkv).to(dt)
    qk, v = proj.split(DIM, dim=-1)
    ctx = _context(qk, _swap_pairs(qk), _swap_pairs(v), _swap_pairs(mask))
    return _tail_plain(x, ctx, *tail)


# -- kernel wrappers ----------------------------------------------------------


def _refuse_grad(name: str, x, weights) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in weights)):
        raise RuntimeError(
            f"{name}: the fused blocks are inference-only and got a tensor that "
            "requires grad; call under torch.no_grad(), or train through the "
            "unfused route (lightglue_forward(..., fused=False))"
        )


def _check(name: str, x, mask, weights, groups: int) -> None:
    if x.dim() != 3 or x.shape[-1] != DIM or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {x.dtype}")
    if mask.shape != x.shape[:2] or mask.dtype != torch.bool or mask.device != x.device:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} {mask.dtype} {mask.device}")
    shapes = [
        (DIM, groups * DIM), (groups * DIM,), (DIM, DIM), (DIM,), (2 * DIM, 2 * DIM),
        (2 * DIM,), (2 * DIM,), (2 * DIM,), (2 * DIM, DIM), (DIM,),
    ]
    if len(weights) != len(shapes):
        raise ValueError(f"{name}: {len(weights)} weight operands, want {len(shapes)}")
    for i, (w, shape) in enumerate(zip(weights, shapes)):
        want = x.dtype if len(shape) == 2 else torch.float32
        if tuple(w.shape) != shape or w.dtype != want or w.device != x.device:
            raise ValueError(
                f"{name}: weight operand {i} is {tuple(w.shape)} {w.dtype} on {w.device}, "
                f"want {shape} {want} on {x.device}"
            )
        if not w.is_contiguous():
            raise ValueError(f"{name}: weight operand {i} is not contiguous")


def fused_self_block(x, cos, sin, mask, weights) -> torch.Tensor:
    """One self-attention block. x (B, K, 256) bf16 or f32; cos, sin
    (B, K, 32) f32; mask (B, K) bool (real keys); weights from
    ``prep_self_weights`` in x's type. Returns (B, K, 256) in x's type."""
    _refuse_grad("fused_self_block", x, weights)
    if x.device.type == "cpu":
        return fused_self_block_plain(x, cos, sin, mask, weights)
    if x.device.type != "cuda":
        raise ValueError(f"fused_self_block: unsupported device {x.device}")
    _check("fused_self_block", x, mask, weights, 3)
    b, k, _ = x.shape
    for name, t in (("cos", cos), ("sin", sin)):
        if tuple(t.shape) != (b, k, HEAD_DIM // 2) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"fused_self_block: {name} {tuple(t.shape)} {t.dtype}")
    xc, cc, sc, mc = x.contiguous(), cos.contiguous(), sin.contiguous(), mask.contiguous()
    qkv = torch.empty((3, b, HEADS, k, HEAD_DIM), dtype=x.dtype, device=x.device)
    ctx = torch.empty_like(xc)
    out = torch.empty_like(xc)
    err = _build.library().ssl_fused_self_block(
        xc.data_ptr(), cc.data_ptr(), sc.data_ptr(), mc.data_ptr(),
        *(w.data_ptr() for w in weights),
        qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(),
        b, k, int(x.dtype == torch.bfloat16), _build.stream_of(x),
    )
    _build.check(err, "fused_self_block")
    _build.count("fused_self_block")
    return out


def fused_cross_block(x, mask, weights) -> torch.Tensor:
    """One bidirectional cross-attention block over pair rows. x (2P, K, 256)
    bf16 or f32; mask (2P, K) bool; weights from ``prep_cross_weights`` in
    x's type. Returns (2P, K, 256) in x's type."""
    _refuse_grad("fused_cross_block", x, weights)
    if x.device.type == "cpu":
        return fused_cross_block_plain(x, mask, weights)
    if x.device.type != "cuda":
        raise ValueError(f"fused_cross_block: unsupported device {x.device}")
    _check("fused_cross_block", x, mask, weights, 2)
    b, k, _ = x.shape
    if b % 2:
        raise ValueError(f"fused_cross_block: {b} rows do not form pairs")
    xc, mc = x.contiguous(), mask.contiguous()
    qkv = torch.empty((2, b, HEADS, k, HEAD_DIM), dtype=x.dtype, device=x.device)
    ctx = torch.empty_like(xc)
    out = torch.empty_like(xc)
    err = _build.library().ssl_fused_cross_block(
        xc.data_ptr(), mc.data_ptr(),
        *(w.data_ptr() for w in weights),
        qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(),
        b, k, int(x.dtype == torch.bfloat16), _build.stream_of(x),
    )
    _build.check(err, "fused_cross_block")
    _build.count("fused_cross_block")
    return out


# -- the address model of the bf16 linears ------------------------------------

# lightglue_layer.cu's tiling of the bf16 linears: rows a block, warps, the
# bytes of a weight ring slot and the slots (BM, NWARPS, SLOT and RING
# there; edit both together).
GEMM_ROWS, GEMM_WARPS, GEMM_SLOT, GEMM_RING = 32, 8, 32768, 3


def gemm_layout(kernel: str = "tail", rows: int = GEMM_ROWS, warps: int = GEMM_WARPS,
                slot: int = GEMM_SLOT, ring: int = GEMM_RING) -> dict:
    """The shared-memory address model of ``lightglue_layer.cu``'s bf16
    linears, ``kernel`` "proj" (``proj_mma_kernel``) or "tail"
    (``tail_mma_kernel``), in bytes.

    Keys: ``tiles``: name -> (offset, bytes, chunks a row) of the bf16 row
    tiles (proj: ``x`` (rows, 256); tail: ``ctx`` (rows, 256) and ``h``
    (rows, 512), which holds [x | msg] and then gelu(h)), ``ring`` (offset,
    bytes) of the weight slots, ``red`` (offset, bytes) of LayerNorm's
    partial sums (tail only), ``smem_bytes``, ``nthreads``;
    ``address(r, c, cpr)``: the byte offset in a tile (or slot) of 16-byte
    chunk ``c`` of row ``r``, ``cpr`` chunks a row, stored at chunk ``(c &
    ~7) | ((c ^ r) & 7)``; ``stream``: the weight matrices in order as
    (name, k rows, n columns, slices); ``products``: one (A tile, n, first
    slice, slices) per product; ``slice_rows(n)``: k rows a slice of an
    n-wide matrix; ``copy(i, n)``: the (row, chunk) of a slot that cp.async
    copy ``i`` of a slice fills (``i`` = thread + round x nthreads);
    ``load(i)``: the (row, chunk) of a row tile that copy ``i`` fills;
    ``warp_chunk(w, n)``: the first chunk (8 columns) of warp ``w``'s
    columns; ``a_lane(l, mt, kc)``: the (row, chunk) lane ``l`` hands
    ldmatrix for A of row tile ``mt`` at A chunk ``kc`` (a k-step's first);
    ``b_lane(l, ks, wc, h)``: the (slice row, chunk) it hands
    ldmatrix.trans for B of n-tiles 2 h and 2 h + 1 at k-step ``ks`` of a
    slice, the warp's first chunk ``wc``; ``columns(w, n, nt, t)``: the
    accumulator columns (c, c + 1) of lane t's n-tile ``nt``.
    """
    dim, ff = 256, 512
    x_bytes, h_bytes = rows * dim * 2, rows * ff * 2
    if kernel == "proj":
        tiles = {"x": (0, x_bytes, dim // 8)}
        ring_at = x_bytes
        stream = [("Wqkv group", dim, dim, dim * dim * 2 // slot)]
        products = [("x", dim, 0, stream[0][3])]
        red = None
    elif kernel == "tail":
        tiles = {"ctx": (0, x_bytes, dim // 8), "h": (x_bytes, h_bytes, ff // 8)}
        ring_at = x_bytes + h_bytes
        stream = [("Wout", dim, dim, dim * dim * 2 // slot), ("W0", ff, ff, ff * ff * 2 // slot),
                  ("W3", ff, dim, ff * dim * 2 // slot)]
        first = [sum(m[3] for m in stream[:i]) for i in range(3)]
        products = [("ctx", dim, first[0], stream[0][3]), ("h", ff, first[1], stream[1][3]),
                    ("h", dim, first[2], stream[2][3])]
        red = (ring_at + ring * slot, 2 * warps * rows * 4)
    else:
        raise ValueError(f"gemm_layout: kernel {kernel!r}")
    end = ring_at + ring * slot + (red[1] if red else 0)
    return dict(
        kernel=kernel, rows=rows, warps=warps, slot=slot, ring_slots=ring, nthreads=32 * warps,
        tiles=tiles, ring=(ring_at, ring * slot), red=red, smem_bytes=end, stream=stream,
        products=products,
        address=lambda r, c, cpr: (r * cpr + ((c & ~7) | ((c ^ r) & 7))) * 16,
        slice_rows=lambda n: slot // (2 * n),
        copy=lambda i, n: (i // (n // 8), i % (n // 8)),
        load=lambda i: (i >> 5, i & 31),
        warp_chunk=lambda w, n: w * (n // warps) // 8,
        a_lane=lambda l, mt, kc: (16 * mt + (l & 15), kc + (l >> 4)),
        b_lane=lambda l, ks, wc, h: (16 * ks + (l & 15), wc + 2 * h + (l >> 4)),
        columns=lambda w, n, nt, t: (w * (n // warps) + 8 * nt + 2 * t,
                                     w * (n // warps) + 8 * nt + 2 * t + 1),
    )
