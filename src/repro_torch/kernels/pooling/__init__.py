from repro_torch.kernels.pooling.ops import (
    adaptive_matrix, conv1d_matrix, global_matrix, pool_pages_fused,
    pool_pages_grouped, pool_ref, pooling_factors, pooling_matrix,
    pooling_matrix_static, rowmean_matrix, smooth_matrix, tile_matrix)

__all__ = ["adaptive_matrix", "conv1d_matrix", "global_matrix",
           "pool_pages_fused", "pool_pages_grouped", "pool_ref",
           "pooling_factors", "pooling_matrix", "pooling_matrix_static",
           "rowmean_matrix", "smooth_matrix", "tile_matrix"]
