"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``dc_pairs``), and their dispatch (``ops``)."""
