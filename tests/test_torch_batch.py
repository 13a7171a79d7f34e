"""The port's parallel/batch, the mesh arguments and the entry surface on
the CPU: the device step against the JAX package's, and every mesh result
against its unsplit result or the native engine's, with a mesh of two CPU
entries standing for two devices.
"""
import numpy as np
import pytest
import torch

from hevce_tpu.parallel import batch as jbatch
from hevce_tpu.runtime import native as jnative
from hevce_tpu_torch import entry
from hevce_tpu_torch.models import encoder
from hevce_tpu_torch.models import wavefront as wf
from hevce_tpu_torch.ops import fused_eval
from hevce_tpu_torch.parallel import batch as pb
from hevce_tpu_torch.parallel import lockstep
from hevce_tpu_torch.utils.tracing import CARD, PhaseTimer

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

MESH = ("cpu", "cpu")


@pytest.mark.parametrize("sz,n", [(8, 4), (16, 2)])
def test_device_step_equals_jax(sz, n):
    args = pb.random_node_batch(sz, n, seed=sz)
    jargs = jbatch.random_node_batch(sz, n, seed=sz)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a, b)
    got = pb.device_step_fn(sz, 2)(*args)
    want = jbatch.jit_device_step(sz, 2)(*jargs)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mesh_step_equals_unsplit_step(monkeypatch):
    args = pb.random_node_batch(8, 4, seed=1)
    calls = []
    k1 = fused_eval.pipeline_sse

    def counted(sz, qpd6, pred, blk):
        calls.append(pred.shape[0])
        return k1(sz, qpd6, pred, blk)
    monkeypatch.setattr(fused_eval, "pipeline_sse", counted)
    got = pb.device_step_fn(8, 2, mesh=MESH)(*args)
    assert calls == [2] * 10          # five K1 calls a part, 2 rows each
    want = pb.device_step_fn(8, 2)(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert pb.make_mesh(MESH) == (torch.device("cpu"),) * 2


def test_lockstep_mesh_equals_native():
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (32, 32)).astype(np.uint8)
            for _ in range(2)]
    streams, rcons = lockstep.encode_batch(imgs, 3, mesh=MESH)
    for i, im in enumerate(imgs):
        s, r = jnative.encode_image_native(im, 3)
        assert streams[i] == s, f"image {i}"
        np.testing.assert_array_equal(rcons[i], r)


def test_fast_mesh_equals_unsplit(golden, monkeypatch):
    g = golden("images")
    small = [g["img_0"], g["img_1"], g["img_2"]]       # 32x32
    for imgs, fetch_qc in (([g["img_15"], g["img_16"]], False),   # 50x70
                           (small[:2], True)):
        got = wf.encode_batch_fast(imgs, 2, mesh=MESH, fetch_qc=fetch_qc)
        want = wf.encode_batch_fast(imgs, 2, device="cpu", fetch_qc=fetch_qc)
        assert got[0] == want[0]
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
    # a batch of 3 padded to 4 by repeating its last image
    seen, dispatch = [], wf._dispatch_batch

    def spy(images, *a, **kw):
        seen.append(len(images))
        return dispatch(images, *a, **kw)
    monkeypatch.setattr(wf, "_dispatch_batch", spy)
    mesh_timer = PhaseTimer(spans=[])
    got = wf.encode_many_fast(small, 2, batch=3, mesh=MESH, timer=mesh_timer)
    assert seen == [4]
    timer = PhaseTimer(spans=[])
    want = wf.encode_many_fast(small, 2, batch=3, device="cpu", timer=timer)
    assert got[0] == want[0] and len(got[1]) == 3
    # the span tree of the one batch (HEVCE_ADAPT=pre): no card time on the
    # CPU, nor on a mesh, whose spans are the same
    tree = [("prices", None), ("dispatch", None), ("tile", 1), ("upload", 1),
            ("enqueue", 1), ("fetch", None), ("verify", None), ("pack", None)]
    for t in (timer, mesh_timer):
        assert [(s[0], s[3]) for s in t.spans] == tree
        assert len({s[4] for s in t.spans}) == 1 and t.spans[0][4] is not None
        assert all(s[1] <= s[2] for s in t.spans)
        assert CARD not in t.totals
    assert timer.spans[0][4] != mesh_timer.spans[0][4]


def test_adapt_post_stays_single_pass_with_a_mesh(monkeypatch):
    monkeypatch.setenv("HEVCE_ADAPT", "post")
    img = np.random.default_rng(7).integers(0, 256, (32, 32)).astype(
        np.uint8)
    seen, dispatch = [], wf._dispatch_batch

    def spy(images, *a, **kw):
        seen.append(len(images))
        return dispatch(images, *a, **kw)
    monkeypatch.setattr(wf, "_dispatch_batch", spy)
    wf.encode_many_fast([img, img], 2, mesh=MESH)
    assert seen == [2]          # without the mesh a corrective pass follows
    seen.clear()
    wf.encode_many_fast([img, img], 2, device="cpu")
    assert seen == [2, 2]


def test_a_batch_the_mesh_does_not_divide_raises():
    img = np.zeros((32, 32), np.uint8)
    three = pb.random_node_batch(8, 3)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        pb.device_step_fn(8, 2, mesh=MESH)(*three)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        lockstep.encode_batch([img] * 3, 2, mesh=MESH)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        wf.encode_batch_fast([img] * 3, 2, mesh=MESH)
    with pytest.raises(ValueError, match="at least one device"):
        pb.make_mesh([])


def test_entry_runs_on_cpu():
    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    assert tuple(args[3].shape) == (8, 32, 32)
    q1, r1, s1, q4, r4, s4 = fn(*args)
    assert tuple(q1.shape) == (8, 35, 32, 32)
    assert tuple(q4.shape) == (8, 35, 4, 16, 16)
    assert tuple(s1.shape) == tuple(s4.shape) == (8, 35)
    want = pb.device_step(32, 2, *(torch.from_numpy(a) for a in
                                   pb.random_node_batch(32, 8)))
    for g, w in zip((q1, r1, s1, q4, r4, s4), want):
        assert torch.equal(g, w)


def test_new_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 32), np.uint8)
    calls = [lambda: encoder.encode_image(img, 2),
             lambda: entry.entry(),
             lambda: entry.dryrun_multichip(2),
             lambda: pb.make_mesh(),
             lambda: pb.make_mesh(["cuda", "cuda"]),
             lambda: pb.device_step_fn(8, 2, mesh=["cuda"]),
             lambda: lockstep.encode_batch([img], 2, mesh=["cuda"]),
             lambda: wf.encode_batch_fast([img], 2, mesh=["cuda"]),
             lambda: wf.encode_many_fast([img], 2, mesh=["cuda"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    fn, args = entry.entry(device="cpu")
    assert len(fn(*args)) == 6
