"""Ray sharding over ranks (``train.data_parallel``): the rank group and
its collectives (``mesh``) and the start of the ranks (``launch``)."""

from spurfies_tpu_torch.parallel.mesh import (
    RankGroup,
    current,
    make_group,
    shard_views,
)
