"""Fused RSS visibility resolve + aggregate: CUDA kernels (`kernel`), their
plain PyTorch versions (`ref`) and the public ops (`ops`)."""
