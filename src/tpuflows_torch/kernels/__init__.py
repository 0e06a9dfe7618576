"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Importing a module here compiles nothing: a kernel is built with
nvcc on its first launch (see `cuda_build.build`)."""
