from repro_torch.kernels.maxsim.ops import (centroid_scores,
                                            centroid_scores_ref,
                                            maxsim_chunked_ref,
                                            maxsim_rerank, maxsim_scores,
                                            maxsim_scores_chunked,
                                            maxsim_scores_pipelined,
                                            maxsim_topk_chunked,
                                            quantize_int8)
from repro_torch.kernels.maxsim.ref import NEG, dequantize, maxsim_ref

__all__ = ["NEG", "centroid_scores", "centroid_scores_ref", "dequantize",
           "maxsim_chunked_ref", "maxsim_ref", "maxsim_rerank",
           "maxsim_scores", "maxsim_scores_chunked",
           "maxsim_scores_pipelined", "maxsim_topk_chunked",
           "quantize_int8"]
