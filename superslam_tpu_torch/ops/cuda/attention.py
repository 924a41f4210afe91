"""Key-masked scaled dot-product attention for LightGlue, differentiable.

``masked_attention`` is the port of
``superslam_tpu/ops/pallas/attention.py::masked_attention``: softmax over
keys of q k^T / sqrt(64) with masked keys at -1e9, the probabilities cast
to v's type before the PV product. The forward kernel is
``masked_attention.cu``, the backward kernels ``attention_bwd.cu`` (the
port of the JAX function's custom VJP, ``_sdpa_bwd``); their headers say
what bounds them on the H100 and how the designs answer that (both
forward kernels, bf16 and f32, are in ``attention.cuh``, which the fused
LightGlue blocks share; ``fwd_layout`` and ``bwd_layout`` below are the
address models of the forward and backward kernels). A CPU tensor goes
through ``masked_attention_plain`` and ``masked_attention_backward_plain``.

One ``torch.autograd.Function`` serves every device, so a result carries a
``grad_fn`` on the card as on the CPU. It saves q, k, v and the mask (the
JAX VJP's residuals) and, on the card, the forward's output and its row
statistics (each query row's softmax maximum and 1 / sum, written by the
forward kernel only when a gradient is wanted), which the backward kernels
read instead of recomputing the softmax; under ``torch.no_grad()`` nothing
is saved and the forward writes no statistics. The mask gets no gradient.
Launches count as ``masked_attention`` (forward) and
``masked_attention_bwd`` (backward).

A query row whose keys are all masked gets the uniform mean of v over the
N real keys (masked logits are replaced, not offset), as the XLA route of
the JAX package does. Its Pallas kernel pads N to a multiple of 128 with
masked zero keys, so there such a row gets n/n_pad times that mean. The
backward is the gradient of this forward: a replaced logit is a constant,
so in such a row only dv is non-zero (``_sdpa_bwd`` offsets the logits
instead; the two agree wherever a row has one real key).
"""

from __future__ import annotations

import torch

from . import _build

HEAD_DIM = 64
NEG = -1e9


def _inner_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 inside, except f64 inputs (CPU gradient checks) stay f64."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _masked_probabilities(q, k, key_mask, ft):
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    logits = torch.einsum("bhid,bhjd->bhij", q.to(ft), k.to(ft)) * scale
    logits = torch.where(
        key_mask[:, None, None, :], logits, torch.full_like(logits, NEG)
    )
    return torch.softmax(logits, dim=-1), scale


def masked_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor
) -> torch.Tensor:
    """einsum + f32 softmax; q, k, v (B, H, N, D), key_mask (B, N) bool."""
    ft = _inner_dtype(q)
    attn, _ = _masked_probabilities(q, k, key_mask, ft)
    out = torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype).to(ft), v.to(ft))
    return out.to(v.dtype)


def attention_row_stats_plain(
    q: torch.Tensor, k: torch.Tensor, key_mask: torch.Tensor
) -> torch.Tensor:
    """(2, B, H, N) f32: each query row's softmax maximum m (of the scaled
    logits, masked keys at -1e9) and 1 / l (l = sum of exp(logit - m)), the
    row statistics the forward kernel writes for the backward."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    logits = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    logits = torch.where(key_mask[:, None, None, :], logits, torch.full_like(logits, NEG))
    m = logits.amax(dim=-1)
    inv_l = 1.0 / torch.exp(logits - m[..., None]).sum(dim=-1)
    return torch.stack([m, inv_l])


def masked_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    grad_out: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the formula of ``_sdpa_bwd``: the probabilities are
    recomputed in f32, results are cast to the inputs' types. A masked
    logit is a constant of the forward, so its ds is zeroed."""
    ft = _inner_dtype(q)
    p, scale = _masked_probabilities(q, k, key_mask, ft)
    g = grad_out.to(ft)
    dv = torch.einsum("bhij,bhid->bhjd", p, g)
    dp = torch.einsum("bhid,bhjd->bhij", g, v.to(ft))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    ds = torch.where(key_mask[:, None, None, :], ds, torch.zeros_like(ds))
    dq = torch.einsum("bhij,bhjd->bhid", ds, k.to(ft)) * scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, q.to(ft)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name: str, q, k, v, key_mask) -> None:
    b, _, n, d = q.shape
    if d != HEAD_DIM or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: shapes {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
        torch.bfloat16,
        torch.float32,
    ):
        raise ValueError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if key_mask.shape != (b, n) or key_mask.dtype != torch.bool:
        raise ValueError(f"{name}: key_mask {key_mask.shape} {key_mask.dtype}")


def _aligned(name: str, *ts: torch.Tensor) -> None:
    """The kernels read and write 16-byte vectors."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a tensor is not 16-byte aligned (storage offset "
                             f"{t.storage_offset()})")


def _forward(q, k, v, key_mask, with_stats: bool = False):
    """(out, stats): stats is ``attention_row_stats_plain``'s (2, B, H, N)
    f32, written by the kernel on the card, when ``with_stats``, else None."""
    if q.device.type == "cpu":
        out = masked_attention_plain(q, k, v, key_mask)
        return out, attention_row_stats_plain(q, k, key_mask) if with_stats else None
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention: unsupported device {q.device}")
    _check("masked_attention", q, k, v, key_mask)
    b, h, n, _ = q.shape
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    mc = key_mask.contiguous()
    out = torch.empty_like(vc)
    stats = torch.empty((2, b, h, n), dtype=torch.float32, device=q.device) if with_stats else None
    err = _build.library().ssl_masked_attention(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), mc.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(),
        b, h, n, int(q.dtype == torch.bfloat16), _build.stream_of(q),
    )
    _build.check(err, "masked_attention")
    _build.count("masked_attention")
    return out, stats


def masked_attention_with_stats(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward (not differentiable) and its row statistics: (out,
    stats), stats (2, B, H, N) f32 = each query row's softmax maximum and
    1 / sum, the residuals ``masked_attention_backward`` takes with out."""
    with torch.no_grad():
        return _forward(q, k, v, key_mask, with_stats=True)


def masked_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    grad_out: torch.Tensor,
    out: torch.Tensor | None,
    stats: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``masked_attention`` with respect to q, k and v, each
    (B, H, N, 64) in its input's type, given the output's gradient and the
    forward's residuals: its output ``out`` and row statistics ``stats``
    (``masked_attention_with_stats``). A CPU tensor takes
    ``masked_attention_backward_plain``, which ignores both (they may be
    None there); on the card a missing residual raises."""
    if q.device.type == "cpu":
        return masked_attention_backward_plain(q, k, v, key_mask, grad_out)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention_backward: unsupported device {q.device}")
    _check("masked_attention_backward", q, k, v, key_mask)
    b, h, n, _ = q.shape
    for label, t in (("grad_out", grad_out), ("out", out)):
        if t is None or t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            got = None if t is None else (tuple(t.shape), t.dtype, str(t.device))
            raise ValueError(f"masked_attention_backward: {label} {got}")
    if (stats is None or stats.shape != (2, b, h, n) or stats.dtype != torch.float32
            or stats.device != q.device):
        got = None if stats is None else (tuple(stats.shape), stats.dtype, str(stats.device))
        raise ValueError(f"masked_attention_backward: stats {got}, want (2, {b}, {h}, {n}) f32")
    qc, kc, vc, gc, oc = (t.contiguous() for t in (q, k, v, grad_out, out))
    mc, sc = key_mask.contiguous(), stats.contiguous()
    dq, dk, dv = torch.empty_like(qc), torch.empty_like(kc), torch.empty_like(vc)
    _aligned("masked_attention_backward", qc, kc, vc, gc, oc)
    err = _build.library().ssl_masked_attention_bwd(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), mc.data_ptr(), gc.data_ptr(),
        oc.data_ptr(), sc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, n, int(q.dtype == torch.bfloat16), _build.stream_of(q),
    )
    _build.check(err, "masked_attention_backward")
    _build.count("masked_attention_bwd")
    return dq, dk, dv


class _MaskedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        # The row statistics only when a gradient will be asked for, and only
        # on the card: the CPU backward recomputes the softmax.
        with_stats = q.device.type == "cuda" and any(ctx.needs_input_grad[:3])
        out, stats = _forward(q, k, v, key_mask, with_stats)
        ctx.save_for_backward(q, k, v, key_mask, out if with_stats else None, stats)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q, k, v, key_mask, out, stats = ctx.saved_tensors
        dq, dk, dv = masked_attention_backward(q, k, v, key_mask, grad_out, out, stats)
        return dq, dk, dv, None


def masked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor
) -> torch.Tensor:
    """(B, H, N, 64) q, k, v in bf16 or f32 + (B, N) bool key mask ->
    (B, H, N, 64) in v's type; differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _MaskedAttention.apply(q, k, v, key_mask)
    return _forward(q, k, v, key_mask)[0]  # no graph: no residuals, no statistics


# attention_bwd.cu's tiling: the block's own rows, the rows of a walked tile
# and the warps across a walked tile (BR, BC, WC there; edit both together).
BWD_ROWS, BWD_WALK, BWD_WARP_COLS = 64, 64, 2


def bwd_layout(rows: int = BWD_ROWS, walk: int = BWD_WALK, warp_cols: int = BWD_WARP_COLS) -> dict:
    """The shared-memory address model of ``attention_bwd.cu`` (both
    kernels), in 4-byte words.

    Keys: ``pitch`` (68 words a staged row) and ``red_pitch`` (72, the
    reduction scratch); ``planes``: name -> (offset, rows) of each staged
    plane (``own0``, ``own1``: the block's two own tensors, q and dO in the
    dq kernel, k and v in the dk/dv kernel; ``walk0``, ``walk1``: the walked
    tile's two, k and v or q and dO; each with a ``b`` (big) and an ``s``
    (small) plane), ``raw`` (offset, words) of the staging buffer that
    cp.async fills with the next walked tile (up to three tensors of walk x
    64 elements, unpadded), ``vectors`` (offset, words) of the per-row
    vectors, ``red_region`` (offset, rows) of the reduction scratch
    (aliasing the walked planes after the loop; dV's rows, then dK's),
    ``smem_bytes``, ``nthreads``, ``warps``: the (first own row, first
    walked row) of each warp, ``ntc``: n-tiles of a warp's logits. Word offsets inside a plane, for lane ``l`` (g = l >> 2,
    t = l & 3):

    - ``a_rows(l, m0, k0, reg)``: A register ``reg`` of an S-type product
      (row m0 + g + 8 (reg & 1), column k0 + t + 4 (reg >> 1));
    - ``b_rows(l, n0, k0, reg)``: its B register ``reg`` (row n0 + g,
      column k0 + t + 4 reg);
    - ``b_perm(l, n0, kk, nt, reg)``: B register ``reg`` of a product whose
      A is a warp's accumulators, k permuted (row n0 + 8 kk + 2t + reg,
      column 8 nt + g);
    - ``stage(i)``: the (row, column) of the 4-word chunk that staging
      index i stores (i = thread + round x nthreads), and of the 4-element
      chunk of each raw tensor that it copies and reads back;
    - ``red(l, m0, nt, hr)``: the float2 of the reduction scratch for rows
      m0 + g + 8 hr, column 8 nt + 2t.
    """
    ld, rld = 68, 72
    wr = rows // 16
    planes, off = {}, 0
    for name, n in (("own0", rows), ("own1", rows), ("walk0", walk), ("walk1", walk)):
        for part in "bs":
            planes[name + part] = (off, n)
            off += n * ld
    raw = (off, 3 * walk * 64)
    off += raw[1]
    vectors = (off, 3 * walk + 3 * rows)
    return dict(
        pitch=ld, red_pitch=rld, planes=planes, raw=raw, vectors=vectors,
        red_region=(planes["walk0b"][0], 2 * rows), smem_bytes=4 * (off + vectors[1]),
        nthreads=32 * wr * warp_cols, ntc=walk // warp_cols // 8,
        warps=[(16 * (w % wr), walk // warp_cols * (w // wr)) for w in range(wr * warp_cols)],
        a_rows=lambda l, m0, k0, reg: (m0 + (l >> 2) + 8 * (reg & 1)) * ld + k0 + (l & 3) + 4 * (reg >> 1),
        b_rows=lambda l, n0, k0, reg: (n0 + (l >> 2)) * ld + k0 + (l & 3) + 4 * reg,
        b_perm=lambda l, n0, kk, nt, reg: (n0 + 8 * kk + 2 * (l & 3) + reg) * ld + 8 * nt + (l >> 2),
        stage=lambda i: (i >> 4, (i & 15) * 4),
        red=lambda l, m0, nt, hr: (m0 + (l >> 2) + 8 * hr) * rld + 8 * nt + 2 * (l & 3),
    )


# attention.cuh's tiling: the query rows of a block of the bf16 and of the
# f32 forward kernel, the keys of a tile and the bf16 kernel's key/value
# ring slots (BQ, FQ, KT and KSTAGES there; edit both together).
FWD_BF16_ROWS, FWD_F32_ROWS, FWD_KEYS, FWD_BF16_STAGES = 64, 64, 64, 2


def fwd_layout(dtype: str = "bf16", rows: int | None = None, keys: int = FWD_KEYS,
               stages: int = FWD_BF16_STAGES) -> dict:
    """The shared-memory address model of ``attention.cuh``'s forward
    kernels (``dtype`` "bf16" or "f32"; ``rows``: the block's query rows,
    16 a warp, default the source's).

    ``"bf16"`` (``attn_fwd_bf16_kernel``), in bytes: ``tiles``: name ->
    (offset, rows) of the query tile ``q`` and the key and value tiles of
    each of the ``stages`` ring slots ``u``, ``k<u>`` then ``v<u>``, each
    row 64 bf16 = 8 chunks
    of 16 bytes, chunk ``j`` of row ``r`` stored at chunk ``j ^ (r & 7)``
    (``address(r, j)``, in a tile); ``copy(i)``: the (row, chunk) that
    cp.async copy ``i`` of a tile fills; the (row, chunk) each lane ``l``
    hands ldmatrix: ``q_lane(l, warp, ks)`` (A, k-step ``ks`` of 16
    columns), ``k_lane(l, ks, hh)`` (B of n-tiles 2 hh and 2 hh + 1 of S),
    ``v_lane(l, kk, j)`` (ldmatrix.trans: B of output n-tiles 2 j and 2 j +
    1 over keys 16 kk .. 16 kk + 15).

    ``"f32"`` (``attn_fwd_f32_kernel``), in 4-byte words: ``pitch`` (68),
    ``planes``: name -> (offset, rows) of the staged ``kb``, ``ks``,
    ``vb``, ``vs`` (big and small), ``raw`` (offset, words) of the next
    tile's k and v as cp.async lands them (64 x 64 each, unpadded); the
    query tile is staged once through the same planes (big rows from
    ``kb`` on, small rows from ``vb`` on); word offsets in a plane for lane
    ``l`` (g = l >> 2, t = l & 3): ``q_frag(l, warp, kk, reg)`` (A register
    ``reg`` of columns 8 kk .., row 16 warp + g + 8 (reg & 1), column 8 kk
    + t + 4 (reg >> 1)), ``b_rows(l, nt, kk, reg)`` (B of S: row 8 nt + g,
    column 8 kk + t + 4 reg), ``b_perm(l, kk, nt, reg)`` (B of P V with k
    permuted: row 8 kk + 2t + reg, column 8 nt + g); ``stage(i)``: the
    (row, column) of the 4-word chunk that staging index ``i`` writes.

    Both: ``smem_bytes``, ``nthreads``, ``rows``, ``keys``.
    """
    if dtype == "bf16":
        rows = FWD_BF16_ROWS if rows is None else rows
        rb = 128
        tiles = {"q": (0, rows)}
        off = rows * rb
        for u in range(stages):
            for name in "kv":
                tiles[f"{name}{u}"] = (off, keys)
                off += keys * rb
        return dict(
            dtype=dtype, rows=rows, keys=keys, stages=stages, nthreads=2 * rows, row_bytes=rb,
            tiles=tiles,
            smem_bytes=off,
            address=lambda r, j: r * rb + ((j ^ r) & 7) * 16,
            copy=lambda i: (i >> 3, i & 7),
            q_lane=lambda l, warp, ks: (16 * warp + (l & 15), 2 * ks + (l >> 4)),
            k_lane=lambda l, ks, hh: (16 * hh + 8 * (l >> 4) + (l & 7), 2 * ks + ((l >> 3) & 1)),
            v_lane=lambda l, kk, j: (16 * kk + (l & 15), 2 * j + (l >> 4)),
        )
    if dtype != "f32":
        raise ValueError(f"fwd_layout: dtype {dtype!r}")
    rows = FWD_F32_ROWS if rows is None else rows
    ld = 68
    planes, off = {}, 0
    for name in ("kb", "ks", "vb", "vs"):
        planes[name] = (off, keys)
        off += keys * ld
    raw = (off, 2 * keys * 64)
    return dict(
        dtype=dtype, rows=rows, keys=keys, nthreads=2 * rows, pitch=ld, planes=planes, raw=raw,
        smem_bytes=4 * (off + raw[1]),
        q_frag=lambda l, warp, kk, reg: ((16 * warp + (l >> 2) + 8 * (reg & 1)) * ld
                                         + 8 * kk + (l & 3) + 4 * (reg >> 1)),
        b_rows=lambda l, nt, kk, reg: (8 * nt + (l >> 2)) * ld + 8 * kk + (l & 3) + 4 * reg,
        b_perm=lambda l, kk, nt, reg: (8 * kk + 2 * (l & 3) + reg) * ld + 8 * nt + (l >> 2),
        stage=lambda i: (i >> 4, (i & 15) * 4),
    )
