"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
torch version: paged decode attention so far."""
