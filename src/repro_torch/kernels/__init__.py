# Hand-written Hopper kernels of the port, written as axe.program stage
# graphs (see repro_torch.kernels.programs, the canonical entry points).
# Each kernel module keeps its plain torch version beside the CUDA
# wrapper; CPU tensors run the plain version, CUDA tensors the kernel.
