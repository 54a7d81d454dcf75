from .collectives import ShardContext  # noqa: F401
from .mesh import make_mesh, params_pspec, shard_context, shard_pytree  # noqa: F401
from .train_step import build_sharded_eval_step, build_sharded_train_step  # noqa: F401
