"""The parallel layer on torch.distributed (counterpart of
keypoint_bench_tpu/parallel): the rank mesh and its collectives, the
data-parallel evaluation steps, head-sharded LightGlue, sequence-sharded
VO, ring attention with sequence-parallel LightGlue, and the two-stage
pipeline."""
