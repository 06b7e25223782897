from keypoint_bench_tpu_torch.runtime.loader import (NativePrefetcher,
                                                     load_pnm_resized,
                                                     native_available)

__all__ = ["NativePrefetcher", "load_pnm_resized", "native_available"]
