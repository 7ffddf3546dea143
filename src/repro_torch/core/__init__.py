"""N:M format, sparse-linear execution policy and the SparseLinear layer."""
