"""hevce_tpu_torch: the PyTorch/CUDA port of hevce_tpu.

Mirrors hevce_tpu's layout (ops/, models/, runtime/, bitstream/, parallel/,
utils/) and computes the same integer codec math on tensors with an
explicit device. It imports neither jax nor hevce_tpu. Entry points run on
the card unless the caller passes device="cpu": the wavefront fast mode
(models/wavefront.encode_many_fast) and the bit-exact lockstep engine
(parallel/lockstep.encode_batch).
"""
