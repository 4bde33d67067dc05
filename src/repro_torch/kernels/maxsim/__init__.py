from repro_torch.kernels.maxsim.ops import (maxsim_rerank, maxsim_scores,
                                            maxsim_scores_chunked)
from repro_torch.kernels.maxsim.ref import NEG, maxsim_ref

__all__ = ["NEG", "maxsim_ref", "maxsim_rerank", "maxsim_scores",
           "maxsim_scores_chunked"]
