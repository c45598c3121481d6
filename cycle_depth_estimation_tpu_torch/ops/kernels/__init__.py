"""Hand-written Hopper kernels, one module each, with their plain torch
versions beside them. Importing a module compiles nothing: a kernel is built
(``nvcc``) or JIT-compiled (Triton) at its first launch."""
