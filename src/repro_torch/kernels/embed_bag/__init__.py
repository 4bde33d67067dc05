from repro_torch.kernels.embed_bag.ops import embed_bag
from repro_torch.kernels.embed_bag.ref import embed_bag_ref

__all__ = ["embed_bag", "embed_bag_ref"]
