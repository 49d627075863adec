"""Many scenes per step on one card, and scenes sharded over the ranks of
a `torch.distributed` process group (see `mesh.py`)."""

from .mesh import (  # noqa: F401
    DEVICE_AXIS,
    HOST_AXIS,
    SCENE_AXIS,
    Mesh,
    batched_sort_scan,
    batched_sort_step,
    batched_sort_step_chunked,
    batched_visual_scan,
    batched_visual_step,
    batched_visual_step_chunked,
    batched_visual_step_inplace,
    new_batched_state,
    new_batched_visual_state,
    pod_mesh,
    pod_sharded_sort_scan,
    scene_mesh,
    shard_batched_state,
    sharded_sort_scan,
    sharded_sort_step,
    sharded_visual_scan,
    sharded_visual_step,
)
from .gallery import (  # noqa: F401
    global_gallery_query,
    local_gallery_query,
    merge_shard_topk,
)
from .handoff import track_merge, track_migration  # noqa: F401
from .dryrun import dryrun_multichip  # noqa: F401
