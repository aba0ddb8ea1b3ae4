"""gtsam_points_tpu_torch — the PyTorch/CUDA port of the JAX package
gtsam_points_tpu, which stays beside it as the reference. This package mirrors its
subpackage layout (utils, types, ops, factors, optim, pipelines) and function
names, in PyTorch's idiom: plain functions on tensors, NamedTuple/dataclass
state, an explicit `device` on every entry point, and hand-written Hopper
kernels (CUDA C++ under `csrc/`) where the JAX package used Pallas.

Entry points run on `cuda` unless the caller passes `device="cpu"`; they never
drop to the CPU on their own (see `_device.py`).
"""

import torch as _torch

# Registration accuracy depends on full-f32 arithmetic (the JAX package pins
# "highest" matmul precision for the same reason). TF32 keeps ~3 decimal
# digits, so both matmul and cuDNN TF32 are switched off.
_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from gtsam_points_tpu_torch.types.frame import Frame, make_frame, merge_frames, transform_frame  # noqa: E402
from gtsam_points_tpu_torch.utils import se3  # noqa: E402

__version__ = "0.1.0"
