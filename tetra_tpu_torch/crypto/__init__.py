"""crypto layer of the PyTorch/CUDA port (mirrors tetra_tpu.crypto)."""
