"""The board sharded over a device mesh: one tile per mesh slot, halo
exchange between neighbouring tiles (counterpart of
``akka_game_of_life_tpu/parallel``, single-process form)."""

from akka_game_of_life_tpu_torch.parallel.mesh import (  # noqa: F401
    COL_AXIS,
    ROW_AXIS,
    GridMesh,
    factor_2d,
    gather,
    make_grid_mesh,
    shard_board,
)
from akka_game_of_life_tpu_torch.parallel.halo import (  # noqa: F401
    exchange_halo,
    sharded_step_fn,
    validate_tile_shape,
)
from akka_game_of_life_tpu_torch.parallel.packed_halo import (  # noqa: F401
    make_row_mesh,
    shard_packed,
    sharded_packed_step_fn,
)
from akka_game_of_life_tpu_torch.parallel.packed_halo2d import (  # noqa: F401
    shard_packed2d,
    sharded_gen_step_fn,
    sharded_packed2d_step_fn,
    word_halo_width,
)
from akka_game_of_life_tpu_torch.parallel.sweep_halo import (  # noqa: F401
    plan_exchange,
    sharded_gen_sweep_step_fn,
    sharded_sweep_step_fn,
)
from akka_game_of_life_tpu_torch.parallel.digest import (  # noqa: F401
    sharded_dense_digest_fn,
    sharded_gen_digest_fn,
    sharded_packed2d_digest_fn,
)
