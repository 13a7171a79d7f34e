"""The encoder's carried state: constant tables, as device tensors.

The encoder has no learned weights. What it carries is constant tables (the
transform matrices, the RDOQ level-rate table and weights, the angular
prediction matrices, the last-XY scan constants) plus the per-image bin
prices. numpy_tables() builds the port's own numpy copies;
tables_from_numpy() turns any such set (the port's, or the JAX package's)
into the port's tensors, so a test can hold the two packages' tables equal.
"""
import functools

import numpy as np
import torch

SIZES = (4, 8, 16, 32)


def numpy_tables() -> dict:
    """The port's own tables as numpy arrays (keys = tables_from_numpy's
    arguments)."""
    from hevce_tpu_torch.models import wavefront as wf
    from hevce_tpu_torch.ops import constants as C
    from hevce_tpu_torch.ops import intra

    return dict(
        transform_mat={sz: C.TRANSFORM_MAT[sz] for sz in SIZES},
        level_rate=C.LEVEL_RATE_TABLE,
        rd_weight_dist=C.RDCOST_WEIGHT_DIST,
        rd_weight_bits=C.RDCOST_WEIGHT_BITS,
        shifts={name: np.array([getattr(C, name)[sz] for sz in SIZES],
                               np.int32)
                for name in ("FWD_SHIFT_A", "QUANT_DIST_SHIFT",
                             "QUANT_LEVEL_SHIFT", "DEQUANT_SHIFT")},
        angular={sz: intra._angular_matrix(sz) for sz in SIZES},
        scan={sz: wf._scan_consts(sz) for sz in SIZES},
        prices=(np.array([wf._ctx_default(q) for q in range(5)], np.int32),
                np.full(5, wf.SIG_ZERO, np.int32)),
    )


def tables_from_numpy(transform_mat, level_rate, rd_weight_dist,
                      rd_weight_bits, shifts, angular, scan, prices,
                      device="cpu") -> dict:
    """numpy tables -> the port's tensors on `device`.

    transform_mat / angular / scan: dicts keyed by block size (scan values
    are the (inv, cnt, byp, stm) tuples of models/wavefront._scan_consts);
    shifts: dict of per-size int arrays; prices: the default per-qpd6
    (ctx, sig) bin-price arrays (<<15 fixed point)."""
    dev = torch.device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    return {
        "transform_mat": {sz: t(m, torch.int32)
                          for sz, m in transform_mat.items()},
        # the float64 operands of the exact transform products (ops/xform)
        "transform_f64": {sz: t(m, torch.float64)
                          for sz, m in transform_mat.items()},
        "level_rate": t(level_rate, torch.int32),
        "rd_weight_dist": t(rd_weight_dist, torch.int32),
        "rd_weight_bits": t(rd_weight_bits, torch.int32),
        "shifts": {k: t(v, torch.int32) for k, v in shifts.items()},
        "angular": {sz: t(w, torch.float32) for sz, w in angular.items()},
        # (n, 35*nn) transposed form for the prediction product (ops/intra)
        "angular_t": {sz: t(np.asarray(w, np.float32).reshape(
            -1, w.shape[-1]).T, torch.float32) for sz, w in angular.items()},
        "scan": {sz: tuple(t(a, torch.int32) for a in consts)
                 for sz, consts in scan.items()},
        "prices": tuple(t(p, torch.int32) for p in prices),
    }


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    return tables_from_numpy(**numpy_tables(), device=device)


def tables(device) -> dict:
    """The port's own tables on `device`, built once per device."""
    return _tables(torch.device(device))
