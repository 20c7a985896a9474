"""Device operations of the port: split search and the CUDA kernels."""
