"""Parallelism of the port: the `data` mesh and the `data,space`,
`data,model` and `data,pp` grids over the ranks of a process group, their
collectives, row shards of one image (`parallel.spatial`), the convs'
channels and the training state over a `model` group (`parallel.tensor`),
the residual groups as a pipeline over a `pp` group (`parallel.pipeline`),
and serving over one card or several."""

from facesr_torch.parallel.mesh import (Mesh, NotPorted, batch_sharding, get_mesh,
                                        grid_sharding, pad_to_multiple, pp_param_shardings,
                                        pp_stages, replicate, replicated, row_sharding,
                                        shard_batch, tp_param_shardings)
from facesr_torch.parallel.pipeline import make_pp_apply, pipeline_trunk
from facesr_torch.parallel.serving import (MicroBatcher, Predictor, ShardedPredictor,
                                           SpatialPredictor, build_serving_fn)

__all__ = ["Mesh", "NotPorted", "get_mesh", "replicated", "batch_sharding", "row_sharding",
           "grid_sharding", "tp_param_shardings", "shard_batch", "replicate", "pad_to_multiple",
           "pp_param_shardings", "pp_stages", "make_pp_apply", "pipeline_trunk", "MicroBatcher",
           "Predictor", "ShardedPredictor", "SpatialPredictor", "build_serving_fn"]
