from .mesh import (  # noqa: F401
    make_mesh, shard_batch, decode_sharded, accumulate_sharded)
