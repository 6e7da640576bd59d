"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): HBM bandwidth; float32 outside the tensor
cores, the precision the port's GNN path computes in (TF32 off); and
bfloat16 on the tensor cores, 989 TFLOP/s dense (the sheet's 1,979 is
with 2:4 sparsity), for systems that compute in bfloat16."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for ``flops`` float32 operations
    over ``nbytes`` bytes moved: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S)
