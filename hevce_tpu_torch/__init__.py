"""hevce_tpu_torch: the PyTorch/CUDA port of hevce_tpu.

Mirrors hevce_tpu's layout (ops/, models/, runtime/, bitstream/, parallel/,
utils/) and computes the same integer codec math on tensors with an
explicit device. It imports neither jax nor hevce_tpu. Four entry points,
each on the card unless the caller passes device="cpu" (--device=cpu for
the CLI): the wavefront fast mode (models/wavefront.encode_many_fast), the
bit-exact lockstep engine (parallel/lockstep.encode_batch), the Python
spec encoder (models/encoder.encode_image), and the command line
(python -m hevce_tpu_torch, cli.py). parallel/batch splits the device work
over a mesh of devices (the mesh= argument of the batch drivers); entry.py
holds the flagship device step and the mesh dry run.
"""

from hevce_tpu_torch.version import __version__  # noqa: F401
