"""Device ops of the port: each dispatcher launches a CUDA kernel on
``cuda`` tensors and runs its plain PyTorch version on ``cpu`` tensors."""
