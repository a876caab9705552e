"""Data parallelism over ``torch.distributed`` ranks (port of
``mx_rcnn_tpu/parallel``): :mod:`distributed` (joining the process group,
each rank's rows), :mod:`mesh` (the DP train step), :mod:`elastic` (shrink
and regrow on device loss) and :mod:`dist_smoke` (the two-process smoke).
``spatial.py`` (a ``model`` axis) is not ported."""

from mx_rcnn_tpu_torch.parallel import distributed
from mx_rcnn_tpu_torch.parallel.elastic import (
    ElasticContext,
    ElasticLoop,
    MeshMonitor,
    NoSurvivorsError,
    RegrowPolicy,
    make_elastic_factory,
)
from mx_rcnn_tpu_torch.parallel.mesh import (
    DataMesh,
    make_mesh,
    make_parallel_train_step,
    replica_slices,
    replicate,
    shard_batch,
    take_replica_rows,
)
