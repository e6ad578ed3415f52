"""Parallelism of the port: the `data` mesh and the `data,space` and
`data,model` grids over the ranks of a process group, their collectives,
row shards of one image (`parallel.spatial`), the convs' channels and the
training state over a `model` group (`parallel.tensor`), and serving over
one card or several."""

from facesr_torch.parallel.mesh import (ROADMAP_ITEMS, Mesh, NotPorted, batch_sharding,
                                        get_mesh, grid_sharding, pad_to_multiple, replicate,
                                        replicated, row_sharding, shard_batch,
                                        tp_param_shardings)
from facesr_torch.parallel.serving import (MicroBatcher, Predictor, ShardedPredictor,
                                           SpatialPredictor, build_serving_fn)

__all__ = ["Mesh", "NotPorted", "get_mesh", "replicated", "batch_sharding", "row_sharding",
           "grid_sharding", "tp_param_shardings", "shard_batch", "replicate", "pad_to_multiple",
           "pp_param_shardings", "make_pp_apply", "MicroBatcher", "Predictor",
           "ShardedPredictor", "SpatialPredictor", "build_serving_fn"]


def pp_param_shardings(*args, **kwargs):
    raise NotPorted(f"pp_param_shardings is {ROADMAP_ITEMS['pp']}")


def make_pp_apply(*args, **kwargs):
    raise NotPorted(f"make_pp_apply (GPipe over the residual groups) is {ROADMAP_ITEMS['pp']}")
