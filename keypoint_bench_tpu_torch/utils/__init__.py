"""Host-side helpers of the port (counterpart of keypoint_bench_tpu/utils)."""
