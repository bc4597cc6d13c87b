"""Device kernels grouped by name, for the per-layer metrics.

One table: each group lists name fragments, and a kernel belongs to the
first group one of whose fragments its name contains. A later kernel
brings its name as an entry here. Names that match no group are the
model's elementwise work (casts, LayerNorm, mish, residuals, softmax
statistics, Adam, the decode and NMS).
"""

from __future__ import annotations

GROUPS = (
    # The port's flash attention: csrc/flash_attention_{fwd,bwd}*.cu.
    ("flash_fwd", ("flash_fwd_sm90_kernel", "flash_fwd_kernel",
                   "flash_fwd_halves_kernel", "flash_fwd_wide_",
                   "flash_fwd_cluster_", "flash_fwd_scores_",
                   "flash_fwd_windowed_kernel")),
    ("flash_bwd", ("flash_bwd_sm90_kernel", "flash_bwd_dq_sm90_kernel",
                   "flash_bwd_kernel", "flash_bwd_dq_kernel",
                   "flash_bwd_dq_sum_kernel", "flash_bwd_halves_kernel",
                   "flash_bwd_dq_halves_kernel", "flash_bwd_cluster_",
                   "flash_bwd_dq_cluster_", "flash_bwd_scores_",
                   "flash_bwd_windowed_kernel", "flash_bwd_dq_windowed_kernel")),
    # Matrix products: cuBLAS (cutlass / xmma / nvjet kernels) and the
    # port's fused dense kernels.
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas",
              "splitKreduce", "dense_mish", "int8_dense")),
    # Copies and fills, not kernels.
    ("memcpy", ("Memcpy", "Memset", "memcpy", "memset")),
)


def group_of(name: str) -> str:
    for group, fragments in GROUPS:
        if any(f in name for f in fragments):
            return group
    return "elementwise"
