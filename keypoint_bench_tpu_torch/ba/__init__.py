"""Bundle adjustment."""
from keypoint_bench_tpu_torch.ba.gauss_newton import (BAProblem, ba_solve,
                                                      lm_iterations,
                                                      reprojection_errors)
