"""Causal / sliding-window GQA attention over a whole sequence: the CUDA
kernel (`kernel`), its plain PyTorch version (`ref`) and the model-layout
op (`ops`)."""
