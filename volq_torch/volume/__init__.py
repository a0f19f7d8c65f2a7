from volq_torch.volume.noise import perlin3, fbm3
from volq_torch.volume.bake import bake_bank

__all__ = ["perlin3", "fbm3", "bake_bank"]
