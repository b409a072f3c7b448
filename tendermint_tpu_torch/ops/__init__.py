"""Device ops of the port: the torch field/curve core, the comb-table
path, the generic ladder, and the CUDA kernels they launch (`csrc/`)."""
