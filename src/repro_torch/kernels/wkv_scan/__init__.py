"""The RWKV6 WKV recurrence with data-dependent per-channel decay: the
CUDA kernel (`kernel`), its plain PyTorch version (`ref`) and the public
op in the model's layout (`ops`)."""
