"""Optimizers, LR schedules and gradient compression, in PyTorch."""
from repro_torch.optim.compression import (compress_int8,  # noqa: F401
                                           decompress_int8)
from repro_torch.optim.optimizers import (Optimizer, adafactor,  # noqa: F401
                                          adamw, clip_by_global_norm,
                                          make_optimizer, sgd)
from repro_torch.optim.schedule import (constant_schedule,  # noqa: F401
                                        cosine_schedule)
