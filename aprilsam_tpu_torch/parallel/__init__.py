from .dist import (Mesh, dp_batch_solve, init_group, local_shard, make_mesh,
                   one_rank_group, shard_factor_tables)

__all__ = ["Mesh", "dp_batch_solve", "init_group", "local_shard",
           "make_mesh", "one_rank_group", "shard_factor_tables"]
