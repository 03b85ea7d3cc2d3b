from hashgan_tpu_torch.parallel.data_parallel import (  # noqa: F401
    ReplicaSet,
    gather_rows,
    shard_rows,
    split_rows,
)
from hashgan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
from hashgan_tpu_torch.parallel.sharded_scan import (  # noqa: F401
    ring_hamming_topk,
    shard_grouped_gallery,
    shard_pm8_gallery,
    sharded_groupmin_topk,
    sharded_hamming_topk,
    sharded_mxu_topk,
    sharded_mxu_topk_large,
)
