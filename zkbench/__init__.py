"""The benchmark of the PyTorch and CUDA port, ``myzkp_tpu_torch``."""
