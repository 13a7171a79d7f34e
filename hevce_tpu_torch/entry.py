"""Entry points of the port: a one-device check of the flagship step and a
dry run of the mesh paths (the JAX package's __graft_entry__.py).

Both run on the card unless the caller passes device="cpu".
"""
import time

import numpy as np
import torch

from hevce_tpu_torch.models.wavefront import encode_batch_fast
from hevce_tpu_torch.parallel import batch as pb
from hevce_tpu_torch.parallel.lockstep import encode_batch
from hevce_tpu_torch.runtime.native import decode_stream, encode_image_native
from hevce_tpu_torch.utils import device as _device
from hevce_tpu_torch.utils.synth import SIGMAS, synth_image


def entry(device=None):
    """The flagship device step: dense 35-mode CU candidate evaluation (both
    TU layouts) for a batch of 8 32x32 CTU nodes at qpd6=2. Returns (fn,
    args): fn(*args) runs it, args on the device."""
    dev = _device.resolve(device)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in pb.random_node_batch(32, batch=8))
    return pb.device_step_fn(32, 2), args


def _dryrun_mesh(n_devices: int, device):
    """n_devices entries: the CUDA devices in turn (one H100 gives
    (cuda:0,) * n_devices), or `device` n_devices times."""
    if device is None:
        devs = pb.make_mesh()
        return tuple(devs[i % len(devs)] for i in range(n_devices))
    return pb.make_mesh([device] * n_devices)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Split the device step over a mesh of n_devices entries and run it at
    CU sizes 8 and 32, then the bit-exact lockstep path and the wavefront
    fast mode end to end through the mesh. Raises on any mismatch: the
    lockstep streams must equal runtime/native.encode_image_native's on
    n_devices 64x96 images, and every fast-mode stream on n_devices 128x192
    images must decode to its recon."""
    mesh = _dryrun_mesh(n_devices, device)
    t0 = time.time()

    def tick(msg):
        print(f"dryrun[{time.time() - t0:6.1f}s] {msg}", flush=True)

    for sz in (8, 32):
        args = pb.random_node_batch(sz, batch=2 * n_devices)
        got = pb.device_step_fn(sz, 2, mesh=mesh)(*args)
        want = pb.device_step_fn(sz, 2)(*(torch.from_numpy(a).to(mesh[0])
                                          for a in args))
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"mesh device step at sz={sz} differs "
                                     f"from the unsplit step")
        tick(f"device step sz={sz} ok")

    # a real multi-CTU grid (2x3 CTUs: every CU size and the whole RDO
    # recursion) through the mesh's node and PU steps
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (64, 96)).astype(np.uint8)
            for _ in range(n_devices)]
    streams, rcons = encode_batch(imgs, 4, mesh=mesh)
    for i, im in enumerate(imgs):
        s_ref, r_ref = encode_image_native(im, 4)
        if streams[i] != s_ref or not np.array_equal(rcons[i], r_ref):
            raise AssertionError(f"mesh lockstep image {i} differs from the "
                                 f"native engine's encode")
    tick(f"lockstep mesh encode bit-exact on {n_devices} 64x96 images")

    # the fast mode on textured 128x192 images (R=4, Cc=6: 12 fronts)
    crops = [synth_image(rng, 128, 192, SIGMAS[i % len(SIGMAS)])
             for i in range(n_devices)]
    fs, fr = encode_batch_fast(crops, 2, mesh=mesh)
    for i, s in enumerate(fs):
        if not np.array_equal(decode_stream(s), fr[i]):
            raise AssertionError(f"fast mesh stream {i} does not decode to "
                                 f"its recon")
    tick("wavefront fast mesh encode decode-verified")
    print(f"dryrun_multichip: ok on a mesh of {n_devices} "
          f"({', '.join(str(d) for d in mesh)}): sizes 8/32 at batch "
          f"{2 * n_devices}; lockstep bit-exact on {n_devices} 64x96 images; "
          f"fast mode decode-verified on {n_devices} 128x192 images",
          flush=True)
