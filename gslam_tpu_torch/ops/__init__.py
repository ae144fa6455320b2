"""Device ops: the ORB-style frontend and the Hamming matcher.

Each op has a plain PyTorch version (the port of the jnp reference in
``gslam_tpu/ops``); the detector, the BRIEF sampler and the matcher also
have hand-written CUDA kernels in :mod:`gslam_tpu_torch.ops.cuda`, which
the main path launches on CUDA tensors.
"""
