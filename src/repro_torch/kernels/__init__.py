"""Hand-written Hopper kernels (``csrc/``), their wrappers, and the plain
torch versions they are held against."""

from repro_torch.kernels import flash_attention, nm_spmm, nm_spmv


def all_kernels():
    """Every CUDA kernel launcher of the port, for launch accounting."""
    return [nm_spmv.KERNEL, nm_spmm.KERNEL, flash_attention.KERNEL,
            flash_attention.MLA_KERNEL]


def reset_launch_counts() -> None:
    for k in all_kernels():
        k.launches = 0
