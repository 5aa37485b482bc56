"""SI-V snapshot read (newest slot at or below a watermark): the CUDA
kernel (`kernel`), its plain PyTorch version (`ref`) and the public op
(`ops`)."""
