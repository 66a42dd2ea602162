from vidil_tpu_torch.utils.dist import (
    barrier,
    destroy_distributed,
    get_rank,
    get_world_size,
    init_distributed_mode,
    is_dist_avail_and_initialized,
    is_main_process,
    save_on_master,
    setup_for_distributed,
)
from vidil_tpu_torch.utils.io import load_json, merge_rank_jsons, save_json, shard_range
from vidil_tpu_torch.utils.seeding import seed_everything
