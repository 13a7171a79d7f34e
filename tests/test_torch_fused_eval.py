"""Kernel K1 (the fused candidate evaluation) in the PyTorch port.

On the CPU the wrapper runs K1's plain version; it must equal the JAX
package's XLA op pipeline and its Pallas K1 (interpret mode, as
tests/test_fused_eval.py runs it) bit for bit on every production shape.
The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevce_tpu.models import cu_eval as jcu
from hevce_tpu.ops import fused_eval as jfe
from hevce_tpu.ops import rdcost as jrdcost
from hevce_tpu_torch.models import cu_eval
from hevce_tpu_torch.ops import fused_eval

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

# (sz, M): every shape the wavefront front core issues (RMD K=12 2Nx2N, T=4
# TU-split subs, the dense-35 NxN PUs) plus the dense-35 large sizes
SHAPES = [(4, 35), (4, 4), (8, 4), (8, 12), (16, 4), (16, 12),
          (32, 4), (32, 12), (8, 35), (16, 35), (32, 35)]


def _inputs(sz, M, qpd6, B=5):
    """noise plus the adversarial blocks pred=0/blk=255 and the reverse,
    which drive clip16 and the level escapes."""
    rng = np.random.default_rng(sz * 100 + M + qpd6)
    pred = rng.integers(0, 256, (B, M, sz, sz)).astype(np.uint8)
    blk = rng.integers(0, 256, (B, sz, sz)).astype(np.uint8)
    pred[0], blk[0] = 0, 255
    pred[1], blk[1] = 255, 0
    return pred, blk


def _port(sz, qpd6, pred, blk):
    return [t.numpy() for t in cu_eval.pipeline_sse(
        sz, qpd6, torch.from_numpy(pred), torch.from_numpy(blk))]


@pytest.mark.parametrize("sz,M", SHAPES)
@pytest.mark.parametrize("qpd6", [0, 2, 4])
def test_plain_k1_matches_jax_pipeline_and_kernel(sz, M, qpd6):
    pred, blk = _inputs(sz, M, qpd6)
    n0 = fused_eval.LAUNCHES
    q, r, sse = _port(sz, qpd6, pred, blk)
    assert fused_eval.LAUNCHES == n0           # CPU tensors launch nothing
    assert (q.dtype, r.dtype, sse.dtype) == (np.int16, np.uint8, np.int32)

    jp, jb = jnp.asarray(pred), jnp.asarray(blk)
    q_x, r_x = jcu._pipeline(sz, qpd6, jp, jb)
    sse_x = jrdcost.block_sse(jb[:, None], r_x)
    np.testing.assert_array_equal(q, np.asarray(q_x))
    np.testing.assert_array_equal(r, np.asarray(r_x))
    np.testing.assert_array_equal(sse, np.asarray(sse_x))

    q_k, r_k, sse_k = jfe.pipeline_sse(sz, qpd6, jp, jb)     # interpret mode
    np.testing.assert_array_equal(q, np.asarray(q_k))
    np.testing.assert_array_equal(r, np.asarray(r_k))
    np.testing.assert_array_equal(sse, np.asarray(sse_k))


@pytest.mark.parametrize("lead,sz", [((7, 3), 4), ((1, 1), 8), ((3,), 16),
                                     ((2, 2, 5), 4)])
def test_plain_k1_awkward_row_counts(lead, sz):
    rng = np.random.default_rng(sum(lead) + sz)
    pred = rng.integers(0, 256, lead + (sz, sz)).astype(np.uint8)
    blk = rng.integers(0, 256, lead[:-1] + (sz, sz)).astype(np.uint8)
    q, r, sse = _port(sz, 2, pred, blk)
    jp, jb = jnp.asarray(pred), jnp.asarray(blk)
    q_x, r_x = jcu._pipeline(sz, 2, jp, jb)
    np.testing.assert_array_equal(q, np.asarray(q_x))
    np.testing.assert_array_equal(r, np.asarray(r_x))
    np.testing.assert_array_equal(
        sse, np.asarray(jrdcost.block_sse(jb[..., None, :, :], r_x)))
    q_k, r_k, sse_k = jfe.pipeline_sse(sz, 2, jp, jb)
    np.testing.assert_array_equal(q, np.asarray(q_k))
    np.testing.assert_array_equal(r, np.asarray(r_k))
    np.testing.assert_array_equal(sse, np.asarray(sse_k))

