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
  eval_tusplit  -> (quant (...,T,4,h,h), recon (...,T,sz,sz), sse (...,T)),
                   T = 35 (dense) or the preselected lanes
"""
import torch

from hevce_tpu_torch.ops import fused_eval, fused_node

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
    src/HEVCe.c:1422-1448): prediction (X1 on the card) and K1."""
    pred = fused_node.predict(sz, ctx_top, ctx_left, flags)
    return pipeline_sse(sz, qpd6, pred, blk_orig)


def eval_tusplit(sz: int, qpd6: int, ctx_top, ctx_left, flags, blk_orig,
                 modes=None):
    """four-TU evaluation over a mode-lane axis (reference step 3,
    src/HEVCe.c:1455-1484).

    modes=None: the lane axis is all 35 modes, lane m predicting with mode
    m; the lockstep engine's node step.
    modes (..., T) int32: T preselected lanes (RMD fast mode), lane t
    predicting with mode modes[..., t].

    Sub-TU isub order is z-order; each lane chains through its own
    reconstruction canvas, which X1 (ops/fused_node.predict) reads for the
    next sub-TU's borders. The SSE is the sum of the four sub-TUs'."""
    h = sz // 2
    M = 35 if modes is None else modes.shape[-1]
    canvas = torch.zeros(blk_orig.shape[:-2] + (M, sz, sz),
                         dtype=torch.uint8, device=blk_orig.device)
    quants = []
    for isub, (oy, ox) in enumerate(((0, 0), (0, h), (h, 0), (h, h))):
        pred = fused_node.predict(sz, ctx_top, ctx_left, flags, modes,
                                  canvas, isub)
        q, recon, s = pipeline_sse(h, qpd6, pred,
                                   blk_orig[..., oy:oy + h, ox:ox + h])
        quants.append(q)
        canvas[..., :, oy:oy + h, ox:ox + h] = recon
        sse = s if isub == 0 else sse + s
    return torch.stack(quants, -3), canvas, sse
