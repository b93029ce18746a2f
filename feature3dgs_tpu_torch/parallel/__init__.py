"""Several cameras a step and several cards (``torch.distributed``): the
port of ``feature3dgs_tpu/parallel``."""
from feature3dgs_tpu_torch.parallel.sharded import (  # noqa: F401
    make_mesh,
    rasterize_tile_sharded,
    sharded_train_step,
    stack_cameras,
)
from feature3dgs_tpu_torch.parallel.trainer import DistributedTrainer  # noqa: F401
