"""Hand-written device kernels (see blind_rotate_cuda)."""
