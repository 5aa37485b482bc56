"""RSS set-membership snapshot read (the previous-version read): the CUDA
kernel (`kernel`), its plain PyTorch version (`ref`) and the public op
(`ops`)."""
