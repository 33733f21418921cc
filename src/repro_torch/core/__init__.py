# Compiler front end (copied from the reference) + the CUDA runtime.
