"""Hand-written CUDA kernels for Hopper (``sm_90a``), bound with ctypes.

Each wrapper module (``fastnms``, ``brief``, ``matcher``, ``schur``) takes
its plain PyTorch version for CPU tensors and, for CUDA tensors, launches
its kernel or raises; a module-level counter per kernel (``launches``,
``gated_launches``, ``schur_launches``, ``cost_launches``) counts its
launches.
Sources live in ``gslam_tpu_torch/csrc``; :mod:`.build` compiles them on
first use.  Importing these modules builds nothing.
"""
