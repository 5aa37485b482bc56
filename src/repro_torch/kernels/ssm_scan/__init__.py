"""The Mamba selective scan: the CUDA kernel (`kernel`), its plain
PyTorch version (`ref`) and the public op (`ops`)."""
