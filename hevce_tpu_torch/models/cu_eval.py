"""CU candidate evaluation over a leading mode-lane axis.

For one CU node the reference runs predict -> residual -> DCT -> RDOQ ->
dequant -> iDCT -> reconstruct -> SSE once per (mode, TU layout) candidate
(reference src/HEVCe.c:1422-1484). Here each call evaluates a whole
(lanes, modes) batch as one tensor program.

  ctx_top:  (..., 1 + 2*sz) reconstructed row above the CU, positions
            x-1 .. x+2sz-1 (clamped reads; masked by flags)
  ctx_left: (..., 2*sz) reconstructed column left of the CU
  flags:    (..., 4) bool — bll / blb / baa / bar existence
  blk_orig: (..., sz, sz) uint8 original pixels

  eval_2nx2n    -> (quant (...,35,sz,sz), recon (...,35,sz,sz), sse (...,35))
  eval_tusplit  -> (quant (...,T,4,h,h), recon (...,T,sz,sz), sse (...,T))
"""
import torch

from hevce_tpu_torch.ops import fused_eval, intra, rdcost

# residual -> transform -> RDOQ -> dequant -> inverse -> recon, without the
# SSE: K1's plain version lives beside the kernel, in ops/fused_eval
_pipeline = fused_eval.pipeline_plain


def pipeline_sse(sz: int, qpd6: int, pred, blk_orig):
    """_pipeline + per-candidate SSE. Every candidate evaluation goes through
    here: a CUDA tensor launches kernel K1, a CPU tensor runs its plain
    version (ops/fused_eval.pipeline_sse)."""
    return fused_eval.pipeline_sse(
        sz, qpd6, pred.to(torch.uint8).contiguous(),
        blk_orig.to(torch.uint8).contiguous())


def eval_2nx2n(sz: int, qpd6: int, ctx_top, ctx_left, flags, blk_orig):
    """all-35-mode single-TU evaluation (reference step 2,
    src/HEVCe.c:1422-1448)."""
    S = intra.build_borders(
        sz, ctx_top[..., 0], ctx_left, ctx_top[..., 1:],
        flags[..., 0], flags[..., 1], flags[..., 2], flags[..., 3])
    pred = intra.predict_all_modes(sz, S)
    return pipeline_sse(sz, qpd6, pred, blk_orig)


def _select_pred(sz: int, S, sel_oh):
    """Per-lane selected-mode prediction: S (..., T, n) border vectors,
    sel_oh (..., T, 35) bool with exactly one True per lane. Predict all 35
    modes from each lane's own borders, then one-hot-select the lane's mode
    (masked sum with a single nonzero term — exact)."""
    p35 = intra.predict_all_modes(sz, S)              # (..., T, 35, sz, sz)
    w = sel_oh.to(torch.int32)[..., None, None]
    return (p35.to(torch.int32) * w).sum(-3).to(torch.uint8)


def eval_tusplit(sz: int, qpd6: int, ctx_top, ctx_left, flags, blk_orig,
                 sel_oh):
    """four-TU evaluation over T preselected mode lanes (reference step 3,
    src/HEVCe.c:1455-1484); lane t predicts with its one-hot mode sel_oh
    (..., T, 35).

    Sub-TU isub order is z-order; each lane chains through its own
    reconstruction canvas. Sub-block border existence follows the reference
    tables (src/HEVCe.c:1376-1379)."""
    h = sz // 2
    M = sel_oh.shape[-2]
    bshape = blk_orig.shape[:-2]
    bll, blb, baa, bar = (flags[..., i] for i in range(4))
    true_ = torch.ones_like(bll)
    false_ = torch.zeros_like(bll)
    sub_flags = [
        (bll, bll, baa, baa),
        (true_, false_, baa, bar),
        (bll, blb, true_, true_),
        (true_, false_, true_, false_),
    ]
    offs = [(0, 0), (0, h), (h, 0), (h, h)]

    canvas = torch.zeros(bshape + (M, sz, sz), dtype=torch.uint8,
                         device=blk_orig.device)
    quants = []

    def bc(x):  # broadcast a shared border piece over the mode-lane axis
        return x[..., None, :].expand(x.shape[:-1] + (M,) + x.shape[-1:])

    def bc0(x):
        return x[..., None].expand(bshape + (M,))

    for isub, (oy, ox) in enumerate(offs):
        if isub == 0:
            corner = bc0(ctx_top[..., 0])
            left2 = bc(ctx_left[..., 0:2 * h])
            top2 = bc(ctx_top[..., 1:1 + 2 * h])
        elif isub == 1:
            corner = bc0(ctx_top[..., h])
            # left column: canvas col h-1 rows 0..2h-1 (rows >= h masked)
            left2 = canvas[..., :, 0:2 * h, h - 1]
            top2 = bc(ctx_top[..., 1 + h:1 + 3 * h])
        elif isub == 2:
            corner = bc0(ctx_left[..., h - 1])
            left2 = bc(ctx_left[..., h:3 * h])
            top2 = canvas[..., :, h - 1, 0:2 * h]
        else:
            corner = canvas[..., :, h - 1, h - 1]
            # rows/cols beyond the canvas are masked (blb=bar=0); pad by edge
            lo = canvas[..., :, h:2 * h, h - 1]
            left2 = torch.cat([lo, lo], -1)
            tp = canvas[..., :, h - 1, h:2 * h]
            top2 = torch.cat([tp, tp], -1)

        fl = [bc0(f) for f in sub_flags[isub]]
        S = intra.build_borders(h, corner, left2, top2, *fl)
        pred = _select_pred(h, S, sel_oh)
        sub_orig = blk_orig[..., oy:oy + h, ox:ox + h]
        q, recon, _ = pipeline_sse(h, qpd6, pred, sub_orig)
        quants.append(q)
        canvas[..., :, oy:oy + h, ox:ox + h] = recon

    sse = rdcost.block_sse(blk_orig[..., None, :, :], canvas)
    return torch.stack(quants, -3), canvas, sse
