"""One-token GQA decode attention over a KV cache masked by `valid_len`:
the CUDA kernel (`kernel`), its plain PyTorch version (`ref`) and the
public op (`ops`)."""
