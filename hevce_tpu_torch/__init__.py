"""hevce_tpu_torch: the PyTorch/CUDA port of the hevce_tpu wavefront fast mode.

Mirrors hevce_tpu's layout (ops/, models/, runtime/, bitstream/, utils/) and
computes the same integer codec math on tensors with an explicit device. It
imports neither jax nor hevce_tpu. Entry points run on the card unless the
caller passes device="cpu"; see models/wavefront.encode_many_fast.
"""
