from volq_torch.engine.loop import (frame, frames, cached_slab_banks,
                                    setup, run, time_frames)

__all__ = ["frame", "frames", "cached_slab_banks", "setup", "run",
           "time_frames"]
