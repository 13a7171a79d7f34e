"""Measurement tools of the port, each run as a module:

  python -m hevce_tpu_torch.tools.cuda_probe     the probe kernels P1-P3
  python -m hevce_tpu_torch.tools.profile_front  a fast-mode batch profiled
  python -m hevce_tpu_torch.tools.bench_fused    K1 against its op pipeline

They run on the card unless given --device cpu.
"""
